from setuptools import find_packages, setup

setup(
    name="deepmod_tpu",
    version="0.1.0",
    description=(
        "TPU-native detection of DNA modifications from nanopore "
        "sequencing signals"
    ),
    packages=find_packages(include=[
        "deepmod_tpu", "deepmod_tpu.*",
        "deepmod_tpu_torch", "deepmod_tpu_torch.*",
    ]),
    package_data={
        "deepmod_tpu.native": ["*.cpp", "Makefile", "*.so"],
        "deepmod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "h5py",
        "optax",
    ],
    extras_require={
        "tf-import": ["tensorflow"],
        "eval": ["scikit-learn", "matplotlib", "scipy"],
    },
    entry_points={
        "console_scripts": [
            "deepmod-tpu = deepmod_tpu.cli:main",
            "deepmod-tpu-torch = deepmod_tpu_torch.cli:main",
        ],
    },
)
