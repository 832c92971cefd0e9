"""Plain reference of the BraTS viewer's frame, in plain PyTorch.

It imports nothing of the port and nothing of JAX: what it needs of the
port's plain versions it holds as frozen copies here, and it works out the
content crop, the sweep geometry, stage 1, the compositing, the warp and
the INR field again from the inputs the benchmark makes.

  * ``geometry``: render parameters, content crop, sweep geometry, hat
    weights (frozen copies of ``render/params``, ``render/brats`` and
    ``ops/shearwarp``)
  * ``frame``: stage 1, the compositor and the warp (``ops/composite``'s
    and ``ops/warp``'s plain versions)
  * ``field``: the INR over the strided field points, its first layer
    unfactored (``models/features``, ``models/mlp``)

``Precision`` says in what each part computes; ``STATED`` is what the
configurations state, and ``CONTROLS`` are the steps below it that decide
whether the comparison can fail.
"""
