"""The port's training path on the card. Every test here is marked
``cuda`` and skips where no card is present (it decides inside the test).

This file imports no JAX (the CPU parity tests against JAX are
``tests/test_torch_port_{losses,data,training}.py``); run it on the card
with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_train_cuda.py``.

  * every sampler, loss and model option of ``tests/test_training.py``
    trains on the card through ``train_inr`` (finite losses, an eval);
  * exact resume on the card: 8 steps straight against 4, a save, a load
    and 4 more, parameters within 1e-5 (the bound ``chip_smoke.py`` holds
    at 40 steps);
  * a train step makes no host sync: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronizing call
    (``.item()``, a blocking host-to-device copy) raises; the
    ``optax.contrib`` optimizers included;
  * a U-Net training step on the card against the same step on the CPU
    (full float32 convolutions, ``train/unet_trainer.fp32_convs``): the
    first loss rtol 1e-5, the train-mode logits after two steps within
    1e-3 of their largest (Adam turns the rounding noise of near-zero
    gradients into steps of up to ``lr``).
"""

import numpy as np
import pytest
import torch

from mri_raytracer_tpu_torch.config import TrainConfig
from mri_raytracer_tpu_torch.data import cache as tcache
from mri_raytracer_tpu_torch.data import pool as tpool
from mri_raytracer_tpu_torch.data import sampling
from mri_raytracer_tpu_torch.data.synthetic import write_synthetic_dataset
from mri_raytracer_tpu_torch.models import unet
from mri_raytracer_tpu_torch.models.api import build_model
from mri_raytracer_tpu_torch.train import engine, optimizers, steps, \
    unet_trainer


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_train_cuda")
    write_synthetic_dataset(root, num_cases=3, shape=(16, 16, 12), seed=3)
    return root


def _tiny(dataset, out, **kw):
    """tests/test_training.py's _tiny_config."""
    c = TrainConfig()
    c.data.data_root = str(dataset)
    c.data.case_limit = 3
    c.data.num_folds = 3
    c.data.pool_size = 2
    c.data.pool_refresh = 0
    c.model.hidden_dims = (16, 16)
    c.model.fourier_freqs = 2
    c.train_steps = 12
    c.global_batch = 256
    c.micro_batch = 128
    c.checkpoint_every = 10
    c.log_every = 4
    c.out_dir = str(out)
    c.update(kw)
    return c


VARIANTS = {
    "uniform": {},
    "tumor": dict(sampler="tumor"),
    "balanced": dict(sampler="balanced"),
    "hybrid": dict(sampler="hybrid", kind="coord_injection", dropout=0.2),
    "tv": dict(tv_weight=0.1),
    "boundary": dict(boundary_weight=2.0),
    "two_stage": dict(schedule="two_stage", coord_noise_sigma_start=0.3,
                      coord_noise_sigma_end=0.1),
    "siren": dict(kind="siren"),
    "lion": dict(optimizer="lion", freq_dropout=0.2),
    "muon": dict(optimizer="muon"),
    "prodigy": dict(optimizer="prodigy"),
    "dadapt_adamw": dict(optimizer="dadapt_adamw"),
    "schedule_free_adamw": dict(optimizer="schedule_free_adamw"),
    "momo_adam": dict(optimizer="momo_adam"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variants_train_on_the_card(dataset, tmp_path, name):
    dev = _card()
    s = engine.train_inr(_tiny(dataset, tmp_path, train_steps=4,
                               **VARIANTS[name]))
    assert all(np.isfinite(h["loss"]) for h in s["history"])
    assert np.isfinite(s["eval"]["mean_dice"][0])
    assert all(p.device.type == dev.type for p in s["params"].parameters())


@pytest.mark.cuda
def test_exact_resume_on_the_card(dataset, tmp_path):
    _card()
    full = engine.train_inr(_tiny(dataset, tmp_path / "a", train_steps=8,
                                  checkpoint_every=4))
    engine.train_inr(_tiny(dataset, tmp_path / "b", train_steps=4,
                           checkpoint_every=4))
    resumed = engine.train_inr(_tiny(
        dataset, tmp_path / "c", train_steps=8, checkpoint_every=0,
        resume_from=str(tmp_path / "b" / "inr_trainstate.npz")))
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(
            full["params"].parameters(), resumed["params"].parameters()))
    assert diff <= 1e-5, diff


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform", "hybrid", "tv", "boundary",
                                  "two_stage", "lion", "muon", "prodigy",
                                  "dadapt_adamw", "schedule_free_adamw",
                                  "momo_adam"])
def test_train_step_makes_no_host_sync(dataset, name):
    dev = _card()
    cfg = _tiny(dataset, "unused", **VARIANTS[name])
    cases = tcache.brats.find_cases(dataset)
    cache = tcache.RAMCache(cases, verbose=False)
    boundary = cfg.loss.boundary_weight > 0
    for i in range(cache.n_cases):
        c = cache.get(i)
        c["boundary"] = tcache.ChunkedCache.boundary_map(c["seg"])
    pool = tpool.DevicePool(cache, 2, device=dev, with_boundary=boundary)
    model = build_model(cfg.model, 4)
    params = model.init(torch.Generator().manual_seed(0)).to(dev)
    opt = optimizers.build_optimizer(cfg.optim, 10, params)
    sampler = sampling.make_sampler(cfg.data.sampler, cfg.micro_batch,
                                    model=model)
    noise = steps.make_coord_noise_schedule(
        cfg.optim.coord_noise_sigma_start, cfg.optim.coord_noise_sigma_end,
        10)
    step = steps.build_train_step(model, cfg.loss, opt, sampler, 2, noise)
    g = torch.Generator(device=dev).manual_seed(0)
    args = (params, opt, g, pool.mods, pool.segs)
    step(*args, 1, pool.boundary)  # first call: lazy library set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, 5):
            m = step(*args, i, pool.boundary)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m.loss)) and opt.count == 4


@pytest.mark.cuda
def test_unet_step_on_the_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.normal(size=(4, 64, 64, 4))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 4, (4, 64, 64))
                                 .astype(np.int32))) for _ in range(2)]
    runs = {}
    for d in ("cpu", dev):
        net = unet.create_unet(torch.Generator().manual_seed(0), 4, 4, 8,
                               (64, 64)).to(d)
        step = unet_trainer.make_train_step(
            net, unet_trainer.build_adamw(net, 1e-3), 4)
        with unet_trainer.fp32_convs():
            losses = [float(step(x.to(d), y.to(d))) for x, y in batches]
            logits = unet.unet_apply(net, batches[0][0].to(d), train=True)
        runs[str(d)] = (losses, logits.detach().cpu())
    (lc, gc), (lg, gg) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(lg[0], lc[0], rtol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert float((gg - gc).abs().max()) <= 1e-3 * float(gc.abs().max())
