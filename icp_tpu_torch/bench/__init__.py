"""The benchmark layer of icp_tpu_torch: the counterparts of the repository's
``bench.py`` (``headline``), ``benchmarks/bench_suite.py`` (``suite``),
``benchmarks/gt_init_ba.py`` (``gt_init_ba``), ``benchmarks/bench_scaled.py``
(``scaled``), ``benchmarks/bench_distributed.py`` (``distributed``) and
``benchmarks/bench_scaling.py`` (``scaling``), with what they share in
``common`` and the kernel guard they run before any timing in ``startup``.

Each entry point runs on the card unless it is given ``--device cpu``, and
prints the JSON line of its original plus the card's name and power limit.
Without a card and without ``--device cpu`` it raises. The mesh entry
points (``scaled``, ``distributed``, ``scaling``) take ``--virtual-devices
N``.
"""
