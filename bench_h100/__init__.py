"""The benchmark of ``deepmod_tpu_torch`` on one NVIDIA H100.

``run.py`` is the entry; ``README.md`` says how to run a cell and how to
add a configuration, a traffic mix or a metric as files.
"""
