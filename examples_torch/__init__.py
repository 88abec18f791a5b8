"""The example programs of ``examples/``, on ``chiron_tpu_torch``.

Each module has ``main(device="cuda", ...)``, whose size and iteration
arguments default to the JAX example's values and which returns its results
as a dict, and ``check(results)``, which holds the JAX example's assertions.
Run one as ``python examples_torch/<name>.py`` (``--device cpu`` for a small
run on the CPU; ``--help`` lists the arguments).
"""
