"""Settings for every pytest process of the repo, loaded before ``tests/``.

The CPU suite runs as six xdist workers on an eight-core host, and torch
starts one intra-op thread per core in each worker: 48 threads then contend
for 8 cores, and a test that takes seconds alone takes minutes. One torch
thread per worker lets the workers share the cores instead.

The pin holds for the tests only. The library keeps torch's own thread count,
and a process that a test spawns (the gloo ranks) does not load this file.
"""

import torch

torch.set_num_threads(1)
