"""Which head dims reach the attention kernels: a census of every preset's sites on ``meta`` tensors.

Each preset (Synapse, ACDC, HAM10000, PH2) with each of the encoders
``pvt_v2_b0``, ``pvt_v2_b2``, ``resnet18`` and ``resnet50`` and each model
version (CENet, CENetOrg) at its default DSEB heads, and ResNet-50 at one head
per DSEB (``--diffatt_num_heads 1,1,1``), runs one forward at the preset's
image size on ``meta`` tensors (shapes only, no arithmetic, as
``core/stats.py::model_cost`` runs a model; here the model is built on
``meta`` too). Every call of the router's diff-attention entry
(``router.diff_attention_interleaved``: K1 and K3 on the card) and of its
attention core (``router.flash_attention_core``: K2 and K4, the Nonlocal
blocks and the PVT encoder's attention) is recorded with its heads, token
counts and head dims, and the batch from which the router's 32 MB rule sends
its map to a kernel on the card.

Every diff site lies inside K1's and K3's declared range
(``attention_kernels.HEAD_DIMS``); every attention site inside K2's and K4's,
but for ``OUTSIDE_K2_K4``: ResNet-50's dec3 (d = 1024, routed from 219
images) and dec4 (d = 2048, from 3494), which no preset's batch reaches.
The wide diff sites, and the batch from which each is routed, are pinned to
the census that ``ROADMAP.md`` item 13 carries.
"""

import dataclasses

import pytest
import torch
from torch.utils._device import DeviceContext

from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models import cenet as C
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import router

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

PRESETS = ("synapse", "acdc", "ham10000", "ph2")
ENCODERS = ("pvt_v2_b0", "pvt_v2_b2", "resnet18", "resnet50")
VERSIONS = ("cenet", "cenet_org")

# (tokens, d, dv, routed from) of the two attention sites past K2's and K4's range
OUTSIDE_K2_K4 = {(196, 1024, 1024, 219), (49, 2048, 2048, 3494)}

# (preset, encoder, heads or None for the preset's) -> the diff sites past head
# dim 128 as (h, tokens, d, dv, routed from), every model version alike
WIDE_DIFF = {
    ("acdc", "pvt_v2_b0", None): set(),
    ("acdc", "pvt_v2_b2", None): {(4, 196, 80, 160, 55)},
    ("acdc", "resnet18", None): set(),
    ("acdc", "resnet50", None): {(4, 784, 128, 256, 4), (4, 196, 256, 512, 55)},
    ("ph2", "pvt_v2_b0", None): {(2, 196, 80, 160, 110)},
    ("ph2", "pvt_v2_b2", None): {(2, 196, 160, 320, 110)},
    ("ph2", "resnet18", None): {(2, 196, 128, 256, 110)},
    ("ph2", "resnet50", None): {(2, 3136, 128, 256, 1), (2, 784, 256, 512, 7), (2, 196, 512, 1024, 110)},
    ("synapse", "resnet50", (1, 1, 1)): {(1, 3136, 256, 512, 1), (1, 784, 512, 1024, 14),
                                        (1, 196, 1024, 2048, 219)},
}


class _MetaButLinspace(DeviceContext):
    """Factories on ``meta``, but ``torch.linspace`` on the CPU: the PVT reads
    its drop-path schedule with ``.tolist()``, which a meta tensor cannot give."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.linspace:
            with torch._C.DisableTorchFunction():
                return func(*args, **(kwargs or {}))
        return super().__torch_function__(func, types, args, kwargs)


def routed_from(h, n, m) -> int:
    """The least batch whose fp32 map B·h·N·M·4 passes the router's limit."""
    return router._SMALL_LIMIT // (h * n * m * 4) + 1


def census(monkeypatch, preset, encoder, version, heads=None):
    """The sites of one forward at ``preset``'s image size: {(kind, h, N, M, d, dv)}."""
    sites = set()
    diff, core = router.diff_attention_interleaved, router.flash_attention_core

    def diff_site(q, k, v, lam, **kw):
        sites.add(("diff", q.shape[1] // 2, q.shape[2], k.shape[2], q.shape[3], v.shape[3]))
        return diff(q, k, v, lam, **kw)

    def attn_site(q, k, v, **kw):
        sites.add(("attn", q.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3]))
        return core(q, k, v, **kw)

    cfg = get_preset(preset)
    model_cfg = dataclasses.replace(cfg.model, encoder=encoder, model_version=version)
    if heads is not None:
        model_cfg = dataclasses.replace(model_cfg, diffatt_num_heads=heads)
    cfg = cfg.replace(model=model_cfg)
    with monkeypatch.context() as mp:
        mp.setattr(router, "diff_attention_interleaved", diff_site)
        mp.setattr(router, "flash_attention_core", attn_site)
        mp.setattr(C, "init_weights_", lambda model, gen: model)  # nothing to draw on meta
        with _MetaButLinspace("meta"):
            model = C.build_model(cfg, device="meta", seed=0)
        size = cfg.data.img_size
        with torch.no_grad():
            model(torch.zeros(1, cfg.model.input_channels, size, size, device="meta"))
    return sites


def check_sites(sites, preset, encoder, heads=None):
    """Every diff site inside K1's and K3's range and every attention site
    inside K2's and K4's or named in ``OUTSIDE_K2_K4``; the wide diff sites
    those of ``WIDE_DIFF``. Returns the wide diff sites."""
    (k1_d, k1_dv), (k3_d, k3_dv) = K.HEAD_DIMS["diff_attention_interleaved_fwd"], K.HEAD_DIMS[
        "diff_attention_interleaved_bwd"]
    (k2_d, k2_dv), (k4_d, k4_dv) = K.HEAD_DIMS["attention_fwd"], K.HEAD_DIMS["attention_bwd"]
    assert any(kind == "diff" for kind, *_ in sites) and any(kind == "attn" for kind, *_ in sites)
    wide = set()
    for kind, h, n, m, d, dv in sites:
        if kind == "diff":
            assert d <= min(k1_d, k3_d) and dv <= min(k1_dv, k3_dv), (preset, encoder, h, n, d, dv)
            if d > 128 or dv > 128:
                wide.add((h, n, d, dv, routed_from(h, n, m)))
        elif d > min(k2_d, k4_d) or dv > min(k2_dv, k4_dv):
            assert encoder == "resnet50" and h == 1 and n == m, (preset, encoder, h, n, d, dv)
            assert (n, d, dv, routed_from(h, n, m)) in OUTSIDE_K2_K4, (preset, encoder, n, d, dv)
    if (preset, encoder, heads) in WIDE_DIFF:
        assert wide == WIDE_DIFF[(preset, encoder, heads)], (preset, encoder, heads, wide)
    return wide


@pytest.mark.parametrize("preset", PRESETS)
def test_every_site_of_the_preset_fits_its_kernels(monkeypatch, preset):
    for encoder in ENCODERS:
        found = [check_sites(census(monkeypatch, preset, encoder, version), preset, encoder) for version in VERSIONS]
        assert found[0] == found[1], (preset, encoder, found)  # CENetOrg's sites are CENet's
    if preset == "ham10000":  # the skin presets share their model settings
        assert census(monkeypatch, "ham10000", "resnet50", "cenet") == census(monkeypatch, "ph2", "resnet50", "cenet")


def test_resnet50_at_one_head_reaches_the_widest_diff_sites(monkeypatch):
    sites = census(monkeypatch, "synapse", "resnet50", "cenet", heads=(1, 1, 1))
    wide = check_sites(sites, "synapse", "resnet50", heads=(1, 1, 1))
    assert max(d for _, _, d, _, _ in wide) == K.HEAD_DIMS["diff_attention_interleaved_fwd"][0]
    assert max(dv for _, _, _, dv, _ in wide) == K.HEAD_DIMS["diff_attention_interleaved_fwd"][1]
