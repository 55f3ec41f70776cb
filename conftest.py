# Settings for every pytest process of the repository, each xdist worker
# included: this file lies at the root, so pytest loads it before the
# conftest.py files below it and before any test module.
import torch


def pytest_configure(config):
    """Torch runs on one CPU thread in every test process.  The suite runs
    six pytest workers at once on eight cores: torch's own pool of one
    thread a core in each oversubscribes the cores, and its parallel
    regions then wait on descheduled threads (six port test modules run at
    once took 3 to 6 times longer than with one thread each)."""
    torch.set_num_threads(1)
