"""Every model of the port's registry as an exported serving artifact, on
the CPU: the bar of ``tests/test_export_zoo.py``, with a symbolic batch.
For each name of ``ctvae_torch.models.vae_models`` (aliases included)
and the unregistered TwoStageVAE, at small widths (img 16): every entry
point that ``available_fns`` gives exported at B = 2 (``sample`` at its
3 samples, the others with ``poly_batch``), saved, loaded and served on
one key at B = 2 and 3, equal to the live port on that key (rtol 1e-4 /
atol 1e-5), finite; ``encode`` [B, D]. A labelled model
(ConditionalVAE) takes its labels; a CT model its action entry points.
The loaded artifact runs on the models' draws from the key
(``KeyedDraws``: GammaVAE's gamma, FactorVAE's permutation, the
reparameterisation's normals, the CT model's Gumbel samples). Every
other name is in ``test_torch_export_zoo_more.py``, so that parallel
test workers share them.
"""

import numpy as np
import pytest
import torch

from ctvae_torch.serving import export, inference

IMG = 16
GAUSS = dict(in_channels=3, latent_dim=8, hidden_dims=[8, 16], img_size=IMG)
SMALL = dict(in_channels=3, hidden_dims=[8, 16], img_size=IMG)
VQ = dict(in_channels=3, embedding_dim=8, num_embeddings=8,
          hidden_dims=[8, 16], img_size=IMG)

#: registry name -> its small config's fields
ZOO = {
    "CTMCQVAE": dict(VQ, action_dim=4, codebooks=2,
                     causal_hidden_dims=[16, 8], gamma=1.5),
    "MCQVAE": dict(VQ, codebooks=2),
    "VQVAE": VQ,
    "VanillaVAE": GAUSS, "VAE": GAUSS, "GaussianVAE": GAUSS,
    "BetaVAE": dict(GAUSS, loss_type="B", gamma=10.0, max_capacity=25,
                    Capacity_max_iter=10),
    "LogCoshVAE": dict(GAUSS, alpha=10.0, beta=1.0),
    "DIPVAE": GAUSS, "InfoVAE": GAUSS, "WAE_MMD": GAUSS,
    "ConditionalVAE": dict(GAUSS, num_classes=5),
    "CVAE": dict(GAUSS, num_classes=5),
    "IWAE": dict(GAUSS, num_samples=3),
    "MIWAE": dict(GAUSS, num_samples=3, num_estimates=2),
    "SWAE": dict(GAUSS, num_projections=6),
    "BetaTCVAE": dict(GAUSS, hidden_dims=[8, 8], anneal_steps=10),
    "CategoricalVAE": dict(SMALL, latent_dim=4, categorical_dim=5),
    "GumbelVAE": dict(SMALL, latent_dim=4, categorical_dim=5),
    "JointVAE": dict(GAUSS, categorical_dim=5),
    "GammaVAE": dict(SMALL, latent_dim=8, gamma_shape=8.0),
    "VampVAE": dict(GAUSS, num_components=5),
    "HVAE": dict(SMALL, latent1_dim=8, latent2_dim=6),
    "LVAE": dict(SMALL, latent_dims=[4, 8]),
    "MSSIMVAE": GAUSS,
    "DFCVAE": dict(GAUSS, allow_random_features=True),
    "FactorVAE": dict(GAUSS, gamma=6.4),
    "TwoStageVAE": dict(GAUSS, hidden_dims2=[16, 12]),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as the other port tests run their small
    models (parallel test workers oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name: str):
    from ctvae_torch.models import (TwoStageVAE, build_model, init_weights,
                                    vae_models)
    if name in vae_models:
        return build_model(dict(ZOO[name], name=name), device="cpu")
    model = TwoStageVAE(**ZOO[name], device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval()


def test_the_zoo_covers_the_registry():
    from ctvae_torch.models import vae_models
    assert set(vae_models) | {"TwoStageVAE"} == set(ZOO)


def _args(model, key, B: int) -> dict:
    """Each entry point's arguments at batch B (``sample``: 3 samples)."""
    rng = np.random.default_rng(B)
    x, y = (torch.from_numpy(rng.uniform(size=(B, IMG, IMG, 3)).astype(
        np.float32)) for _ in range(2))
    if getattr(model, "needs_labels", False):
        labels = torch.nn.functional.one_hot(torch.arange(B) % 5, 5).float()
        return {"reconstruct": (key, x, labels), "encode": (key, x, labels),
                "sample": (key, labels.repeat(2, 1)[:3])}
    A = getattr(model, "action_dim", 1)
    action = torch.nn.functional.one_hot(torch.arange(B) % A, A).float()
    return {"reconstruct": (key, x), "encode": (key, x), "sample": (key,),
            "apply_action": (key, x, y, action),
            "classify_action": (key, x, y)}


#: every other name here, the rest in test_torch_export_zoo_more.py
NAMES = sorted(ZOO)


def zoo_round_trip(tmp_path, name: str) -> None:
    model = _model(name)
    names = inference.available_fns(model)
    assert {"reconstruct", "encode"} <= set(names)
    key = torch.tensor(7)
    entries = {ep: export.EntryPoint(model, ep, num_samples=3)
               for ep in names}
    example = _args(model, key, 2)
    art = export.save_artifact(str(tmp_path / "art"), {
        ep: export.export_fn(e, example[ep], poly_batch=ep != "sample")
        for ep, e in entries.items()}, {"model": name})
    loaded, manifest = export.load_artifact(art)
    assert manifest["model"] == name and set(loaded) == set(entries)
    for B in (2, 3):
        args = _args(model, key, B)
        for ep, entry in entries.items():
            got = loaded[ep](*args[ep])
            with torch.inference_mode():
                want = entry(*args[ep])
            assert bool(torch.isfinite(got).all()), (name, ep)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}.{ep}")
        z = loaded["encode"](*args["encode"])
        assert z.ndim == 2 and z.shape[0] == B, name


@pytest.mark.parametrize("name", NAMES[::2])
def test_zoo_export_round_trip(tmp_path, name):
    zoo_round_trip(tmp_path, name)
