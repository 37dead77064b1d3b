"""The plain reference: float64 resizes worked out from the geometry and
the configuration alone.

``plan.py``, ``steps.py``, ``geometry.py``, ``complexity.py``,
``compose.py``, ``design.py``, ``params.py``, ``lanczos.py`` and
``lancir_plan.py`` are a frozen copy of avir_tpu_torch's planner (its
``plan/`` and ``filters/`` modules and ``params.py``), so that a change
to the port's planner cannot move the yardstick.  ``dense.py`` turns the
planned operators into dense float64 matrices and applies them with plain
PyTorch; ``avir.py`` and ``lancir.py`` build a ``Reference`` for a
configuration.  Nothing in this package imports ``jax``, ``avir_tpu`` or
``avir_tpu_torch``.
"""
