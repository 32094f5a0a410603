"""Port parity: the flash-attention kernel's plain version
(`repro_torch.kernels.flashattn`) against the reference's Pallas kernel
(interpret mode, bq = bk = 64) and its plain version, on the CPU, at the
four configurations of the reference's kernel tests in f32 and bf16; and
`models.attention.project_qkv` + the plain flash version against the
port's `full_attention` (and the reference's) on the yi-6b SMOKE config.
Inputs come from numpy with a seed and cross as data.

Tolerances are the reference tests' own: f32 atol 3e-5 (the Pallas
kernel's online softmax against one whole-row softmax), bf16 atol 3e-2
(the plain version rounds the softmax weights to bf16 before P.V, the
kernel keeps them in f32), the model comparison atol and rtol 3e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.flashattn import kernel as jkernel, ref as jref
from repro.models import attention as JA
from repro.models.config import Runtime as JRuntime
from repro_torch import configs
from repro_torch.kernels.flashattn import ops, ref
from repro_torch.models import attention as A
from repro_torch.models.config import Runtime

CONFIGS = [
    dict(B=2, S=128, Hq=4, Hkv=2, hd=64, causal=True, window=0),
    dict(B=1, S=256, Hq=8, Hkv=8, hd=32, causal=True, window=0),
    dict(B=2, S=128, Hq=4, Hkv=1, hd=64, causal=False, window=0),
    dict(B=1, S=256, Hq=4, Hkv=2, hd=64, causal=True, window=64),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(cfg, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(cfg["B"], cfg["S"], cfg["Hq"], cfg["hd"])
    k = rng.randn(cfg["B"], cfg["S"], cfg["Hkv"], cfg["hd"])
    v = rng.randn(cfg["B"], cfg["S"], cfg["Hkv"], cfg["hd"])
    return [a.astype(np.float32) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_flash_matches_reference_kernel(cfg, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    arrs = _qkv(cfg)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    kw = dict(causal=cfg["causal"], window=cfg["window"])
    got = ops.flash_attention(tq, tk, tv, bq=64, bk=64, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    want = jkernel.flash_attention(jq, jk, jv, bq=64, bk=64, **kw)
    g = got.float().numpy()
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=atol)
    # the plain versions of both packages: the same arithmetic
    np.testing.assert_allclose(
        g, np.asarray(jref.attention(jq, jk, jv, **kw), np.float32),
        atol=1e-5 if dtype == "f32" else 1e-2)


def _smoke_layer():
    jcfg = jconfigs.get("yi_6b", smoke=True)
    p = JA.init_attention(jax.random.key(0), jcfg)
    tp = {k: torch.from_numpy(np.array(p[k])) for k in ("wq", "wk", "wv",
                                                           "wo")}
    x = np.random.RandomState(1).randn(2, 128, jcfg.d_model).astype(
        np.float32)
    return jcfg, p, tp, x


def test_project_qkv_matches_reference():
    jcfg, p, tp, x = _smoke_layer()
    cfg = configs.get("yi-6b", smoke=True)
    pos = np.arange(128)
    want = JA._project_qkv(p, jcfg, jnp.asarray(x), jnp.asarray(x),
                           pos[None], pos[None])
    got = A.project_qkv(tp, cfg, torch.from_numpy(x),
                        torch.arange(128)[None])
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_flash_matches_model_attention():
    """project_qkv + the flash version + wo against `full_attention` (the
    path the kernel would replace), as the reference's kernel test does."""
    jcfg, p, tp, x = _smoke_layer()
    cfg = configs.get("yi-6b", smoke=True)
    tx = torch.from_numpy(x)
    y_model = A.full_attention(tp, cfg, Runtime(attn_chunk=64), tx)
    q, k, v = A.project_qkv(tp, cfg, tx, torch.arange(128)[None])
    o = ops.flash_attention(q, k, v, bq=64, bk=64)
    y_flash = o.reshape(2, 128, -1) @ tp["wo"]
    np.testing.assert_allclose(y_flash.numpy(), y_model.numpy(), atol=3e-4,
                               rtol=3e-4)
    y_ref = JA.full_attention(p, jcfg, JRuntime(mesh=None, attn_chunk=64),
                              jnp.asarray(x))
    np.testing.assert_allclose(y_flash.numpy(), np.asarray(y_ref),
                               atol=3e-4, rtol=3e-4)


def test_flash_checks_tiling_and_backend():
    q = torch.zeros((1, 96, 2, 32))
    with pytest.raises(ValueError, match="multiple of bq"):
        ops.flash_attention(q, q, q, bq=64, bk=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, bq=32, bk=32, backend="cuda")
    assert ops.smem_bytes(64, 64, 128) <= ops.MAX_SMEM
    assert ops.smem_bytes(128, 128, 128) > ops.MAX_SMEM
