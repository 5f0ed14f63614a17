"""The port's forward-only kernel wrappers refuse a gradient, on the CPU as
on the card, as gtax's Pallas kernels have none.

On the card a wrapper's CUDA kernel writes its outputs through ctypes, so
a result would carry no gradient: `dit_apply(backend="pallas")` under
autograd would train on zero gradients for everything upstream of the
attention. Each wrapper raises instead when grad mode is on and a tensor
input requires grad, on both devices (the CPU's plain versions are
differentiable, but a CPU run must not train where the card cannot). The
trainable branches call the fused wrappers inside their autograd
Functions, where grad mode is off, and keep training. gtax raising on the
same calls under jax.grad is pinned beside each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as jkattn
from gtax.models import dit as jdit
from gtax.nn import attention as jattn
from gtax_torch.kernels import attention, block, pair, quant, vae_block
from gtax_torch.models import dit as tdit
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.trainer import Trainer
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    B, JCFG, T, TCFG, _random_params, _requires_grad, _torch_params,
    interpret_mode)

torch.set_num_threads(2)

N, S, D, HEADS, HID = 2, 12, 64, 2, 256


def _args(name):
    """CPU inputs of one wrapper, x first."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    def q(*shape):
        return quant.quantize_weight(r(*shape, std=0.05))

    x = r(N, S, D)
    vecs = [r(N, D, std=0.1) for _ in range(3)]
    sfreqs = r(S, D // HEADS, std=0.3)
    tfreqs = r(N, D // HEADS, std=0.3)
    if name == "fused_spatial_branch":
        return (x, *vecs, r(D, 3 * D, std=0.05), r(D, D, std=0.05),
                r(D, std=0.01), sfreqs, HEADS)
    if name == "fused_mlp_branch":
        return (x, *vecs, r(D, HID, std=0.05), r(HID, std=0.01),
                r(HID, D, std=0.05), r(D, std=0.01))
    if name == "fused_temporal_branch":
        return (x, *vecs, r(D, 3 * D, std=0.05), r(D, D, std=0.05),
                r(D, std=0.01), tfreqs, None, HEADS, N)
    if name == "fused_temporal_step":
        return (x, *vecs, r(D, 3 * D, std=0.05), r(D, D, std=0.05),
                r(D, std=0.01), r(N * 4 * S, D), r(N * 4 * S, D),
                r(5, D // HEADS, std=0.3), None, HEADS, 4)
    attn_q = (*q(D, 3 * D), *q(D, D), r(D, std=0.01))
    mlp_q = (*q(D, HID), r(HID, std=0.01), *q(HID, D), r(D, std=0.01))
    if name == "fused_spatial_branch_q":
        return (x, *vecs, *attn_q, sfreqs, HEADS)
    if name == "fused_mlp_branch_q":
        return (x, *vecs, *mlp_q)
    if name == "fused_temporal_branch_q":
        return (x, *vecs, *attn_q, tfreqs, None, HEADS, N)
    if name == "fused_temporal_step_q":
        return (x, *vecs, *attn_q, r(N * 4 * S, D), r(N * 4 * S, D),
                r(5, D // HEADS, std=0.3), None, HEADS, 4)
    vecs6 = [r(N, D, std=0.1) for _ in range(6)]
    if name == "fused_spatial_pair_q":
        return (x, *vecs6, *attn_q, *mlp_q, sfreqs, HEADS)
    if name == "fused_temporal_pair_q":
        return (x, *vecs6, *attn_q, *mlp_q, r(N * 4 * S, D),
                r(N * 4 * S, D), r(5, D // HEADS, std=0.3), None, HEADS, 4)
    if name == "fused_vae_block":
        return (x, 1.0 + r(D, std=0.1), r(D, std=0.1),
                r(D, 3 * D, std=0.05), r(3 * D, std=0.01),
                r(D, D, std=0.05), r(D, std=0.01), 1.0 + r(D, std=0.1),
                r(D, std=0.1), r(D, HID, std=0.05), r(HID, std=0.01),
                r(HID, D, std=0.05), r(D, std=0.01),
                r(S, D // HEADS // 2, std=0.3), HEADS)
    if name == "fused_sdpa":
        return (r(N, HEADS, S, D // HEADS), r(N, HEADS, S, D // HEADS),
                r(N, HEADS, S, D // HEADS))
    return (x, r(N, S, D), r(N, S, D), HEADS)  # fused_mha_token_major


WRAPPERS = {
    "fused_spatial_branch": block, "fused_mlp_branch": block,
    "fused_temporal_branch": block, "fused_temporal_step": block,
    "fused_spatial_branch_q": quant, "fused_mlp_branch_q": quant,
    "fused_temporal_branch_q": quant, "fused_temporal_step_q": quant,
    "fused_spatial_pair_q": pair, "fused_temporal_pair_q": pair,
    "fused_vae_block": vae_block, "fused_sdpa": attention,
    "fused_mha_token_major": attention}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_a_gradient(name):
    """A requires_grad input under grad mode raises, naming the wrapper;
    under no_grad the same call runs and returns what it returned before
    (a tensor with no gradient)."""
    fn = getattr(WRAPPERS[name], name)
    args = _args(name)
    x = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name} is forward-only"):
        fn(x, *args[1:])
    with torch.no_grad():
        out = fn(x, *args[1:])
    assert out.grad_fn is None and torch.isfinite(out).all()
    assert torch.equal(out, fn(*args))


def _window(seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, 8, 6, 8)).astype(np.float32),
            r.integers(0, 1000, (B, T)).astype(np.int32),
            r.standard_normal((B, T, 25)).astype(np.float32))


def test_pallas_dit_apply_refuses_a_gradient_as_gtax():
    """dit_apply(backend="pallas") under autograd raises in the port
    (fused_mha_token_major refuses); jax.grad of gtax's dit_apply under
    `pallas` raises as well (its Pallas attention cannot be linearized).
    Without a gradient both run."""
    x, t, a = _window(0)
    jp = _random_params(1)
    prev = jattn.get_backend()
    jattn.set_backend("pallas")
    try:
        def jloss(p):
            return jnp.sum(jdit.dit_apply(
                p, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(a),
                compute_dtype=jnp.float32))

        with pytest.raises(Exception, match="[Ll]ineariz"):
            jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    finally:
        jattn.set_backend(prev)
    tp = _requires_grad(_torch_params(jp))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(a))
    with pytest.raises(RuntimeError, match="forward-only"):
        tdit.dit_apply(tp, TCFG, *args, compute_dtype=torch.float32,
                       backend="pallas")
    with torch.no_grad():
        v = tdit.dit_apply(tp, TCFG, *args, compute_dtype=torch.float32,
                           backend="pallas")
    assert torch.isfinite(v).all()


def test_gtax_pallas_attention_has_no_gradient():
    """The root of the rule: jax.grad through gtax's fused_sdpa (interpret
    mode) raises."""
    q = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 8, 16)).astype(np.float32))
    with pytest.raises(Exception, match="[Ll]ineariz"):
        jax.grad(lambda a: jnp.sum(jkattn.fused_sdpa(a, q, q)))(q)


def test_trainer_refuses_pallas_before_a_step():
    """Trainer(attention_backend="pallas") raises at construction, saying
    why."""
    cfg = TrainingConfig.from_dict(dict(
        dataset_type="dummy", attention_backend="pallas", save_every=0,
        compute_dtype="float32", dit_model="DiT-debug",
        vae_model="vae-debug"))
    with pytest.raises(ValueError, match="gtax's Pallas attention"):
        Trainer(cfg, total_dataset_size=8, device="cpu")
