"""torch's intra-op threads in the port's CPU tests.

The whole suite runs as several pytest-xdist workers on one machine
(ROADMAP, Tier-1 verify: 6 workers); each torch process starts one intra-op
thread a core, so the workers' threads oversubscribe the cores and spin
against each other. Four workers over four of the port's test files took
330 s at torch's default and 205 s at 2 threads a process on an 8-core
machine; one file alone, 137 s and 149 s. Every tests/test_torch_*.py
module caps the threads when it is imported (pytest-xdist imports every
module in every worker), so the cap holds for the whole process; a file run
alone is capped too. The DDPPO tests' rank processes take
M2H_TEST_THREADS (1) instead (tests/_torch_ddppo_rank.py)."""

import torch

TEST_THREADS = 2


def cap_torch_threads() -> None:
    if torch.get_num_threads() > TEST_THREADS:
        torch.set_num_threads(TEST_THREADS)
