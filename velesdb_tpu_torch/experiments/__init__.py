"""The four kernel experiments of ``benchmarks/``, ported.

Each ``exp_*`` module runs as ``python -m velesdb_tpu_torch.experiments.exp_<name>``
on the card (``--device cuda``, the default) or on the CPU through the plain
versions (``--device cpu``, at a small size), and its ``main()`` returns its
results. ``kernels`` holds the experiments' own kernels (#11, #12's epilogues),
``_common`` the oracles and the timing protocol they share.
"""
