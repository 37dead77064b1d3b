"""The benchmark of avir_tpu_torch, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` measures one cell of ``BENCHMARK.json`` on the CUDA card
and prints one JSON line.  Everything that belongs to one configuration,
traffic mix or metric sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``,
``metrics/<metric>.py``, ``programs/<resizer>.py`` (the call into the
port) and ``reference/<resizer>.py`` (the plain float64 reference).
Nothing here imports ``jax`` or the JAX package ``avir_tpu``.
"""
