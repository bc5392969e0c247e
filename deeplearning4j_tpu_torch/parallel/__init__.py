"""Parallel, long-sequence and resilient training of the port: plain
attention (``longseq.py``), the resilient-training runtime
(``resilience.py``, ``elastic.py``), the preemption coordinator
(``multihost.py``) and training telemetry (``telemetry.py``).
ParallelWrapper and the sharded paths come with ROADMAP.md queue A,
item 14."""
