"""Data parallelism across processes: DDPPO's control plane
(``ddppo.py``) and the collectives of the updates (``dist.py``)."""
