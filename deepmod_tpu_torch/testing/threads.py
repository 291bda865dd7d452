"""The port's CPU tests run torch on one thread.

Under the test suite's parallel workers torch's own intra-op threads
contend for the cores, and its small CPU ops ran hundreds of times
slower. A test module takes the fixture by importing it::

    from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for the module's tests; the old count after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
