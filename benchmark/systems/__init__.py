"""Systems a configuration runs, one module each, named by its
``"system"`` key. A module provides:

  * ``build(cfg, traffic, seed, device)``: the program under test, made
    from the seed, with ``request(i)`` (frame ``i``'s arguments, made
    before the call is timed), ``serve(args)`` (the timed call, returning
    the answer on the host), ``warmup()`` and ``close()``;
  * ``reference(cfg, traffic, seed, device)``: the plain reference, made
    from the seed alone, with ``cam(i)``, ``frame(cam, precision)`` (the
    expected answer and the counts of its work), ``work(cam)`` (the
    nominal work, ``counts.FrameWork``) and ``close()``;
  * ``control(cfg, traffic, seed, device, variant)`` and ``controls(cfg)``:
    the reference in a lower precision in the program's place, and the
    variants that apply.
"""
