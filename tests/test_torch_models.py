"""gtax_torch DiT and VAE against the torch-reference golden fixtures (read
through the port's own safetensors reader) and, through the weight bridge,
against gtax's dit_apply / dit_prefill / dit_apply_step.

On the CPU, so the port's kernels run as their plain versions. In fp32 the
tolerances are gtax's own fp32 parity tolerances; the one bf16 test states
its own."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.io import safetensors_port as jport
from gtax.kernels import attention as kattn
from gtax.models import dit as jdit
from gtax.models import vae as jvae
from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit, vae
from tests.conftest import GOLDEN, assert_close

torch.set_num_threads(2)

DIT_SMALL = dit.DiTConfig(
    input_h=18, input_w=32, patch_size=2, in_channels=16, hidden_size=128,
    depth=2, num_heads=4, mlp_ratio=4.0, external_cond_dim=25, max_frames=5)
VAE_SMALL = vae.VAEConfig(
    latent_dim=8, input_height=120, input_width=160, patch_size=20,
    enc_dim=128, enc_depth=2, enc_heads=4, dec_dim=128, dec_depth=3,
    dec_heads=4, mlp_ratio=4.0)
F32 = torch.float32


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


@pytest.fixture(scope="module")
def dit_small():
    state = port.read_safetensors(os.path.join(GOLDEN,
                                               "dit_small.safetensors"))
    params, missing, unexpected = port.dit_from_torch(state, DIT_SMALL)
    assert not missing, missing
    assert all("rotary_emb" in k for k in unexpected), unexpected
    return params


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dit_forward_golden(golden, dit_small):
    g = golden("dit_small.npz")
    x, t, a = _t(g["x"]), _t(g["t"]), _t(g["actions"])
    v = dit.dit_apply(dit_small, DIT_SMALL, x, t, a, compute_dtype=F32)
    assert_close(v, g["v_cond"], atol=2e-4, rtol=1e-4, name="conditioned")
    v = dit.dit_apply(dit_small, DIT_SMALL, x, t, None, compute_dtype=F32)
    assert_close(v, g["v_uncond"], atol=2e-4, rtol=1e-4, name="uncond")


def test_dit_growing_window_golden(golden, dit_small):
    """T=3 forward against the reference, and slots [2:] of a padded T=5
    window with the first two slots masked invalid."""
    g = golden("dit_small.npz")
    x, t, a = _t(g["x"]), _t(g["t"]), _t(g["actions"])
    v3 = dit.dit_apply(dit_small, DIT_SMALL, x[:, :3], t[:, :3], a[:, :3],
                       compute_dtype=F32)
    assert_close(v3, g["v_t3"], atol=2e-4, rtol=1e-4, name="T=3")
    pad_x = torch.cat([torch.ones_like(x[:, :2]) * 123.0, x[:, :3]], dim=1)
    pad_t = torch.cat([t[:, :2] * 0, t[:, :3]], dim=1)
    pad_a = torch.cat([torch.zeros_like(a[:, :2]), a[:, :3]], dim=1)
    v5 = dit.dit_apply(dit_small, DIT_SMALL, pad_x, pad_t, pad_a,
                       [False, False, True, True, True], compute_dtype=F32)
    assert_close(v5[:, 2:], g["v_t3"], atol=2e-4, rtol=1e-4, name="padded")


def test_vae_golden(golden):
    g = golden("vae_small.npz")
    state = port.read_safetensors(os.path.join(GOLDEN,
                                               "vae_small.safetensors"))
    params, missing, unexpected = port.vae_from_torch(state, VAE_SMALL)
    assert not missing and not unexpected, (missing, unexpected)
    mean, logvar = vae.vae_encode(params, VAE_SMALL, _t(g["img"]), F32)
    assert_close(mean, g["mean"], atol=2e-4, rtol=1e-4, name="mean")
    assert_close(logvar, g["logvar"], atol=2e-4, rtol=1e-4, name="logvar")
    dec = vae.vae_decode(params, VAE_SMALL, _t(g["mean"]), F32)
    assert_close(dec, g["dec"], atol=2e-4, rtol=1e-4, name="decode")


def test_reader_matches_gtax_reader():
    path = os.path.join(GOLDEN, "dit_small.safetensors")
    ours = port.read_safetensors(path)
    ref = jport.read_safetensors(path)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def test_bf16_safetensors_read(tmp_path):
    """bf16 buffers are read through torch.frombuffer and upcast."""
    from safetensors.torch import save_file

    a = torch.randn(3, 5).to(torch.bfloat16)
    save_file({"w": a, "i": torch.arange(4, dtype=torch.int32)},
              str(tmp_path / "m.safetensors"))
    got = port.read_safetensors(str(tmp_path / "m.safetensors"))
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], a.float())
    assert torch.equal(got["i"], torch.arange(4, dtype=torch.int32))


# ------------------------------------------------------- weight bridge

def _gtax_debug_params():
    """gtax DiT_debug params with NONZERO adaLN heads (gtax zeroes them at
    init, which would make every block the identity)."""
    cfg = jdit.DiT_debug()
    params = jdit.dit_init(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(7)
    blocks = dict(params["blocks"])
    for name in ("s_adaln", "t_adaln"):
        key, k1, k2 = jax.random.split(key, 3)
        shape = blocks[name]["kernel"].shape
        blocks[name] = {
            "kernel": jax.random.normal(k1, shape) * 0.02,
            "bias": jax.random.normal(k2, shape[:1] + shape[2:]) * 0.02}
    params = dict(params, blocks=blocks)
    return cfg, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def bridged():
    jcfg, jparams = _gtax_debug_params()
    return jcfg, jparams, dit.DiT_debug(), port.dit_from_gtax(jparams)


def _window(seed, B=2, T=5):
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    t = gen.integers(0, 1000, (B, T)).astype(np.int32)
    a = gen.standard_normal((B, T, 25)).astype(np.float32)
    return x, t, a


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True]])
def test_bridge_dit_apply(bridged, valid):
    jcfg, jparams, cfg, params = bridged
    x, t, a = _window(0)
    ref = jdit.dit_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(a),
                         None if valid is None else jnp.asarray(valid),
                         compute_dtype=jnp.float32)
    got = dit.dit_apply(params, cfg, _t(x), _t(t), _t(a), valid,
                        compute_dtype=F32)
    assert_close(got, ref, atol=2e-4, rtol=1e-4)


def test_bridge_prefill_and_step(bridged):
    """dit_prefill's K/V cache and dit_apply_step's v against gtax's (both
    run gtax's fused kernels in interpret mode)."""
    jcfg, jparams, cfg, params = bridged
    jp = jdit.unstack_for_inference(jax.tree.map(jnp.asarray, jparams), jcfg)
    x, t, a = _window(1)
    valid = [False, True, True, True, True]
    jvalid = jnp.asarray(valid)
    jmods = jdit.dit_cond(jp, jcfg, jnp.asarray(t), jnp.asarray(a),
                          jnp.float32)
    mods = dit.dit_cond(params, cfg, _t(t), _t(a), F32)
    for blk, jblk in zip(mods["blocks"], jmods["blocks"]):
        for k in ("s", "t"):
            assert_close(blk[k], jblk[k], atol=1e-5)

    def rows(tree, sl):
        return jax.tree.map(lambda m: m[:, sl], tree)

    jkv = jdit.dit_prefill(jp, jcfg, jnp.asarray(x[:, :-1]),
                           rows(jmods, slice(0, 4)), jvalid[:-1],
                           jnp.float32)
    kv = dit.dit_prefill(params, cfg, _t(x[:, :-1]),
                         {"blocks": [{k: m[:, :4] for k, m in b.items()}
                                     for b in mods["blocks"]],
                          "final": mods["final"][:, :4]},
                         valid[:-1], F32)
    for (k, v), (jk, jv) in zip(kv, jkv):
        assert_close(k, jk, atol=2e-4, rtol=1e-4, name="k")
        assert_close(v, jv, atol=2e-4, rtol=1e-4, name="v")
    ref = jdit.dit_apply_step(jp, jcfg, jnp.asarray(x[:, -1:]), jkv,
                              rows(jmods, slice(4, 5)), jvalid, jnp.float32)
    got = dit.dit_apply_step(params, cfg, _t(x[:, -1:]), kv,
                             {"blocks": [{k: m[:, 4:] for k, m in b.items()}
                                         for b in mods["blocks"]],
                              "final": mods["final"][:, 4:]},
                             valid, F32)
    assert_close(got, ref, atol=2e-4, rtol=1e-4)
    # and the step equals the full window's last slot in the port itself
    full = dit.dit_apply(params, cfg, _t(x), _t(t), _t(a), valid,
                         compute_dtype=F32)
    assert_close(got, full[:, -1:], atol=1e-5)


def test_bridge_bf16_serving_path(bridged):
    """The serving dtype: bf16 weights (cast_params_for_inference on both
    sides), dit_cond, the prefill's K/V cache, the step and the full window
    against gtax's. The adaLN outputs are bit-equal (same bf16 rounding
    points); the rest may differ by a bf16 rounding or two, because gtax's
    temporal cores round each q*k and p*v product to bf16 where the port
    accumulates in fp32 -> 2**-6 of the largest output magnitude (four bf16
    ulps at the top of the range)."""
    jcfg, jparams, cfg, params = bridged
    bf, jbf = torch.bfloat16, jnp.bfloat16
    params = dit.cast_params_for_inference(params, bf)
    jp = jdit.cast_params_for_inference(
        jdit.unstack_for_inference(jax.tree.map(jnp.asarray, jparams), jcfg),
        jbf)
    x, t, a = _window(3)
    valid = [False, True, True, True, True]
    jvalid = jnp.asarray(valid)

    def close(got, ref, name):
        ref = np.asarray(ref.astype(jnp.float32))
        assert_close(got.float(), ref, atol=2.0**-6 * np.abs(ref).max(),
                     rtol=0, name=name)

    jmods = jdit.dit_cond(jp, jcfg, jnp.asarray(t), jnp.asarray(a), jbf)
    mods = dit.dit_cond(params, cfg, _t(t), _t(a), bf)
    for blk, jblk in zip(mods["blocks"], jmods["blocks"]):
        for k in ("s", "t"):
            np.testing.assert_array_equal(
                blk[k].float().numpy(), np.asarray(jblk[k].astype(jnp.float32)))

    def cut(tree, sl):
        return {"blocks": [{k: m[:, sl] for k, m in b.items()}
                           for b in tree["blocks"]],
                "final": tree["final"][:, sl]}

    ctx, last = slice(0, 4), slice(4, 5)
    jkv = jdit.dit_prefill(jp, jcfg, jnp.asarray(x[:, ctx]), cut(jmods, ctx),
                           jvalid[ctx], jbf)
    kv = dit.dit_prefill(params, cfg, _t(x[:, ctx]), cut(mods, ctx),
                         valid[ctx], bf)
    for (k, v), (jk, jv) in zip(kv, jkv):
        close(k, jk, "k")
        close(v, jv, "v")
    close(dit.dit_apply_step(params, cfg, _t(x[:, last]), kv, cut(mods, last),
                             valid, bf),
          jdit.dit_apply_step(jp, jcfg, jnp.asarray(x[:, last]), jkv,
                              cut(jmods, last), jvalid, jbf), "step")


def test_bridge_matches_gtax_export(bridged, tmp_path):
    """gtax's safetensors export of the same params, read by the port,
    equals the bridged params exactly."""
    jcfg, jparams, cfg, params = bridged
    path = str(tmp_path / "dit.safetensors")
    jport.save_dit(path, jax.tree.map(jnp.asarray, jparams), jcfg)
    loaded = port.load_dit(path, cfg)

    def flat(tree):
        out = {}
        dit._map_params(tree, lambda p, leaf: out.__setitem__(p, leaf))
        return out

    ours, theirs = flat(params), flat(loaded)
    assert set(ours) == set(theirs)
    for p, a in ours.items():
        assert torch.equal(a, theirs[p]), p


def test_bridge_vae():
    jcfg = jvae.VAE_debug()
    jparams = jvae.vae_init(jax.random.PRNGKey(0), jcfg)
    # xavier weights + zero biases leave biases untested; shift them
    jparams = jax.tree.map(lambda l: l + 0.01 if l.ndim == 1 else l, jparams)
    params = port.vae_from_gtax(jax.tree.map(np.asarray, jparams))
    gen = np.random.default_rng(2)
    img = gen.uniform(-1, 1, (2, 3, 48, 64)).astype(np.float32)
    jm, jl = jvae.vae_encode(jparams, jcfg, jnp.asarray(img), jnp.float32,
                             fused=True)
    m, lv = vae.vae_encode(params, vae.VAE_debug(), _t(img), F32)
    assert_close(m, jm, atol=2e-4, rtol=1e-4)
    assert_close(lv, jl, atol=2e-4, rtol=1e-4)
    z = gen.standard_normal((2, 48, 8)).astype(np.float32)
    assert_close(vae.vae_decode(params, vae.VAE_debug(), _t(z), F32),
                 jvae.vae_decode(jparams, jcfg, jnp.asarray(z), jnp.float32,
                                 fused=True), atol=2e-4, rtol=1e-4)
