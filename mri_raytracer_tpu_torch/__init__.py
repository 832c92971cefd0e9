"""PyTorch / CUDA port of ``mri_raytracer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every function here
computes what its counterpart there computes, and ``tests/test_torch_port_*``
feed both the same numpy inputs. This package imports ``torch`` and numpy
only — never ``jax`` and nothing of ``mri_raytracer_tpu`` — and keeps its
own copies of the jax-free helpers it needs.

Entry points (``render.brats.BratsRenderer``, ``ops.shearwarp.render_brats``,
``ops.raymarch.render_brats``, ``ops.neural_march.NeuralBratsRenderer``,
``ops.neural_march.render_brats_neural``, ``eval.inference.predict_volume``,
``train.engine.train_inr``, ``train.fit_views.run`` / ``run_shearwarp``,
the secondary renderers (``render.volume.GridVolumeRenderer``,
``ops.sdf.render_sdf``, ``ops.noise2d.render_noise_demo``,
``render.mesh.MeshRenderer``, ``render.hybrid.HybridRenderer``), the
sharded renderers and the bring-up of ``parallel`` (one process a device:
NCCL between cards, gloo between CPU ranks), and the
apps ``python -m mri_raytracer_tpu_torch.apps.brats_app`` / ``.apps.serve``
/ ``.apps.train_inr`` / ``.apps.fit_from_views`` / ``.apps.roi_policy_eval``
/ ``.apps.{volume,sdf,noise,mesh,hybrid}_app``) run on ``cuda`` unless
the caller passes ``device="cpu"`` (``--device cpu``; ``--cpu`` for
``fit_from_views``, ``roi_policy_eval`` and ``hybrid_app``); without a
card they raise. The Pallas kernels of the
JAX package are CUDA C++ kernels here (``csrc/``, built with ``nvcc`` at
first use by ``ops.kernels``). Each kernel's wrapper runs its plain PyTorch
version for CPU tensors (the tests) and launches the kernel for CUDA
tensors.

Module map (port <- JAX package), where the path differs:

    config.py            <- config.py (+ ModelConfig.from_info,
                            TrainConfig.from_args)
    ops/raymarch.py      <- ops/raymarch_xla.py   (the lockstep oracle, the
                            u8 grid renderers)
    ops/composite.py     <- ops/pallas_composite.py (stage 1 + kernel K1)
    ops/warp.py          <- ops/pallas_warp.py      (kernel K2)
    ops/kernels.py       (new: nvcc build + ctypes loader for csrc/*.cu)
    csrc/composite.cu    <- pallas_composite._make_kernel (K1a rows, K1b
                            field, K1c executed-plane counter)
    csrc/warp.cu         <- pallas_warp._make_warp_kernel         (K2)
    io/checkpoint.py     <- io/checkpoint.py: the two npz formats, read and
                            write, the train state (generator state in
                            place of a JAX key); not the torch/orbax loaders
    apps/train_inr.py    <- scripts/train_inr.py (+ --device)
    apps/fit_from_views.py <- scripts/fit_from_views.py
    io/png.py            (new: RGB8 PNG encoder, zlib + struct)
    io/gif.py            (new: GIF89a writer for noise_app's --gif)
    convert.py           (new: JAX-side values, INR and fit weights ->
                            port)
    env.py               (new: torch / CUDA / card / nvcc report, device
                            resolution, fill-made device constants)

Same path on both sides: losses.py, apps/{brats_app,serve,volume_app,
sdf_app,noise_app,mesh_app,hybrid_app}.py, data/{synthetic,brats,nifti,
cache,pool,sampling,codecs}.py, eval/{metrics,inference,roi_protocol}.py,
io/{logging,dashboard}.py, models/{features,mlp,api}.py,
ops/{trilinear,shearwarp,neural_march,diffrender,importance,isosurface,
roi_policy,sdf,noise2d}.py, render/{params,camera,brats,presets,volume,
mesh,hybrid}.py, train/{optimizers,steps,engine,fit_views}.py,
utils/{arith,profiling}.py, parallel/{mesh,training,render}.py (ranks of a
``torch.distributed`` process group in place of a device mesh).
"""
