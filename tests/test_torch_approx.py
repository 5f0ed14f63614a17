"""The approximate serving modes of gtax_torch against gtax's: the
pyramid-pipelined rollout (plain, and with the conditioning cache and
incremental decoding composed in), attention broadcast (dit_apply's cache
modes under every backend, in the exact and the pipelined rollout),
and renoise_last_frame (VideoGenerator with pipeline_depth /
attn_broadcast: tests/test_torch_approx_serving.py).

DiT_debug with nonzero adaLN heads (the weight bridge), a few noise steps,
on the CPU, where the port's wrappers run their plain versions and gtax
its Pallas kernels in interpret mode. gtax's pipelined rollout has no
noise hook: the tests replay its key chain (key, sub = split(key), one
clipped normal a cycle) and pass those draws as the port's `noise=`.

Tolerances: fp32 latents within 1e-4 (gtax's own tolerance for its
rollouts, tests/test_pipelined.py); the composed incremental path within
gtax's 2e-4 / 1e-4 of the plain pipelined one; pixels within 1 LSB (a
uint8 truncation boundary), as tests/test_torch_serving.py. bf16 runs
state their own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.models import dit as jdit
from gtax.nn import attention as jattn
from gtax.sampling import diffusion as jsd
from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit
from gtax_torch.sampling import diffusion as sd
from tests.conftest import assert_close
from tests.test_torch_models import _gtax_debug_params

torch.set_num_threads(2)

F32 = torch.float32
LAT = (8, 6, 8)  # DiT_debug latent (C, H, W)
W = 5


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


def _debug_params():
    """DiT_debug params with nonzero adaLN heads, the heads and the final
    linear scaled up (x5, x50): at dit_init's final std of 0.001 the
    v-prediction is ~1e-3 and the approximate modes would move a rollout
    by no more than fp32 rounding, so no test could tell them apart."""
    jcfg, jp = _gtax_debug_params()
    blocks = dict(jp["blocks"])
    for name in ("s_adaln", "t_adaln"):
        blocks[name] = {k: v * 5 for k, v in blocks[name].items()}
    final = dict(jp["final"], linear=dict(
        jp["final"]["linear"], kernel=jp["final"]["linear"]["kernel"] * 50))
    return jcfg, dict(jp, blocks=blocks, final=final)


@pytest.fixture(scope="module")
def bridged():
    """(gtax cfg, gtax unstacked params, port cfg, port params)."""
    jcfg, jp = _debug_params()
    return (jcfg,
            jdit.unstack_for_inference(jax.tree.map(jnp.asarray, jp), jcfg),
            dit.DiT_debug(), port.dit_from_gtax(jp))


def _inputs(seed, B, n_prompt, n_frames, actions=True):
    rng = np.random.default_rng(seed)
    prompt = rng.standard_normal((B, n_prompt, *LAT)).astype(np.float32)
    acts = (rng.standard_normal((B, n_frames, 25)).astype(np.float32)
            if actions else None)
    return prompt, acts


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def gtax_draws(key, n, B):
    """The clipped normals gtax's pipelined rollout draws from `key`, one a
    cycle, as one (B, n, C, H, W) tensor."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(jnp.clip(jax.random.normal(sub, (B, 1, *LAT),
                                              jnp.float32), -20.0, 20.0))
    return _t(jnp.concatenate(out, axis=1))


def _fns(jcfg, cfg, backend, jdtype=jnp.float32, dtype=F32):
    """(gtax dit_fn, port dit_fn) with params explicit."""

    def jfn(params, x, t, a, valid):
        return jdit.dit_apply(params, jcfg, x, t, a, valid,
                              compute_dtype=jdtype)

    def tfn(params, x, t, a, valid):
        return dit.dit_apply(params, cfg, x, t, a, valid,
                             compute_dtype=dtype, backend=backend)

    return jfn, tfn


def _sampler(steps, K=1):
    return (jsd.SamplerConfig(ddim_noise_steps=steps, stabilization_level=15,
                              attn_broadcast=K),
            sd.SamplerConfig(ddim_noise_steps=steps, stabilization_level=15,
                             attn_broadcast=K))


# ------------------------------------------------ pipelined, plain path

@pytest.mark.parametrize("P,B,n_prompt,actions", [
    (1, 1, 4, True), (2, 2, 4, True), (2, 1, 2, False), (4, 1, 1, True),
    (4, 2, 3, False)])
def test_pipelined_matches_gtax(bridged, P, B, n_prompt, actions):
    """The full-window pipelined rollout, fp32. n_prompt=1 at P=4 runs the
    warm-up with invalid context slots and in-flight slots not yet active;
    at 5 steps and P=4 (stride 2) the newest slots overshoot the schedule
    top and idle."""
    jcfg, jp, cfg, p = bridged
    jfn, tfn = _fns(jcfg, cfg, "xla")
    jcf, tcf = _sampler(5)
    n_gen = 3
    prompt, acts = _inputs(P * 10 + B, B, n_prompt, n_prompt + n_gen,
                           actions)
    key = jax.random.PRNGKey(P + B)
    ref = jsd.make_pipelined_rollout(jfn, W, jcf, pipeline_depth=P)(
        jp, _j(prompt), _j(acts), key, num_gen_frames=n_gen)
    got = sd.make_pipelined_rollout(tfn, W, tcf, pipeline_depth=P)(
        p, _t(prompt), _t(acts), None, n_gen,
        noise=gtax_draws(key, n_gen + P - 1, B))
    assert got.shape == (B, n_prompt + n_gen, *LAT)
    assert_close(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[:, :n_prompt].numpy(), prompt)


def test_pipelined_seeded_draws(bridged):
    """Without `noise`, one clipped (B, 1, C, H, W) draw a cycle from the
    generator: the same seed gives the same rollout, and the draws fed back
    through `noise` reproduce it."""
    _, _, cfg, p = bridged
    _, tfn = _fns(None, cfg, "xla")
    roll = sd.make_pipelined_rollout(tfn, W, _sampler(3)[1],
                                     pipeline_depth=2)
    prompt, acts = _inputs(5, 1, 4, 7)
    a = roll(p, _t(prompt), _t(acts), torch.Generator().manual_seed(4), 3)
    b = roll(p, _t(prompt), _t(acts), torch.Generator().manual_seed(4), 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    g = torch.Generator().manual_seed(4)
    draws = torch.cat([torch.randn((1, 1, *LAT), generator=g).clamp(-20, 20)
                       for _ in range(4)], dim=1)
    np.testing.assert_array_equal(
        roll(p, _t(prompt), _t(acts), None, 3, noise=draws).numpy(),
        a.numpy())


# ---------------------------------- pipelined, cond + incremental composed

@pytest.mark.parametrize("P,B,n_prompt", [(1, 1, 4), (2, 2, 4), (4, 1, 2)])
def test_pipelined_incremental_matches_gtax(bridged, P, B, n_prompt):
    """Per-cycle context prefill + P-live-row steps (dit_apply_step, Tl=P)
    under `fused`, against gtax's composed rollout; and against the port's
    own plain pipelined rollout (fused full window) at gtax's 2e-4 / 1e-4.
    At P=1 it is also the exact incremental make_rollout (the same scheme
    and the same draws)."""
    jcfg, jp, cfg, p = bridged
    jfn, tfn = _fns(jcfg, cfg, "fused")
    jcf, tcf = _sampler(4)
    n_gen = 3
    prompt, acts = _inputs(40 + P, B, n_prompt, n_prompt + n_gen)
    key = jax.random.PRNGKey(7)
    with jattn.backend_scope("fused"):
        ref = jsd.make_pipelined_rollout(
            jfn, W, jcf, pipeline_depth=P,
            cond=jdit.make_cond_fns(jcfg, jnp.float32),
            incremental=jdit.make_incremental_fns(jcfg, jnp.float32))(
            jp, _j(prompt), _j(acts), key, num_gen_frames=n_gen)
    cond = dit.make_cond_fns(cfg, F32, "fused")
    inc = dit.make_incremental_fns(cfg, F32)
    noise = gtax_draws(key, n_gen + P - 1, B)
    args = (p, _t(prompt), _t(acts), None, n_gen)
    fast = sd.make_pipelined_rollout(tfn, W, tcf, pipeline_depth=P,
                                     cond=cond, incremental=inc)(
        *args, noise=noise)
    assert_close(fast, ref, atol=1e-4, rtol=1e-4)
    plain = sd.make_pipelined_rollout(tfn, W, tcf, pipeline_depth=P)(
        *args, noise=noise)
    assert_close(fast, plain, atol=2e-4, rtol=1e-4)
    if P == 1:
        exact = sd.make_rollout(tfn, W, tcf, cond=cond, incremental=inc)(
            *args, noise=noise)
        assert_close(fast, exact, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline_depth=5), "pipeline_depth"),
    (dict(pipeline_depth=0), "pipeline_depth"),
    (dict(incremental=True), "requires the conditioning cache"),
    (dict(incremental=True, cond=True, pab=True), "mutually exclusive")])
def test_pipelined_refuses_what_gtax_asserts(bridged, kw, match):
    """gtax's asserts (1 <= P <= W-1; incremental needs cond; incremental
    excludes broadcast), raised as ValueError."""
    _, _, cfg, _ = bridged
    fns = {"incremental": dit.make_incremental_fns(cfg, F32),
           "cond": dit.make_cond_fns(cfg, F32, "fused"),
           "pab": dit.make_pab_fns(cfg, F32, "fused")}
    kw = {k: fns[k] if v is True else v for k, v in kw.items()}
    kw.setdefault("pipeline_depth", 2)
    _, tcf = _sampler(3, K=2)
    with pytest.raises(ValueError, match=match):
        sd.make_pipelined_rollout(None, W, tcf, **kw)


# ------------------------------------------------- attention broadcast

def _cases(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, W, *LAT)).astype(np.float32)
    t = rng.integers(0, 1000, (B, W)).astype(np.int32)
    a = rng.standard_normal((B, W, 25)).astype(np.float32)
    return x, t, a


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused", "fused_mlp",
                                     "fused_all"])
def test_dit_apply_cache_modes_match_gtax(bridged, backend):
    """collect_cache=True: the v-prediction and every block's two gated
    attention deltas; attn_cache=: a cache collected on another window
    replaces every attention branch (so the result differs from the plain
    forward) — both against gtax's dit_apply on the same inputs, at
    test_bridge_dit_apply's 2e-4 / 1e-4."""
    jcfg, jp, cfg, p = bridged
    valid = [False, True, True, True, True]
    x, t, a = _cases(1)
    x2, t2, a2 = _cases(2)
    with jattn.backend_scope(backend):
        jv, jcache = jdit.dit_apply(jp, jcfg, _j(x), _j(t), _j(a),
                                    _j(valid), compute_dtype=jnp.float32,
                                    collect_cache=True)
        jreuse = jdit.dit_apply(jp, jcfg, _j(x2), _j(t2), _j(a2),
                                _j(valid), compute_dtype=jnp.float32,
                                attn_cache=jcache)
    v, cache = dit.dit_apply(p, cfg, _t(x), _t(t), _t(a), valid,
                             compute_dtype=F32, backend=backend,
                             collect_cache=True)
    assert_close(v, jv, atol=2e-4, rtol=1e-4, name="v")
    assert len(cache) == cfg.depth
    for i, (pair, jpair) in enumerate(zip(cache, jcache)):
        for d, jd in zip(pair, jpair):
            assert d.shape == (2, W, cfg.grid_h, cfg.grid_w, cfg.hidden_size)
            assert d.dtype == F32
            assert_close(d, jd, atol=2e-4, rtol=1e-4, name=f"delta {i}")
    np.testing.assert_array_equal(
        dit.dit_apply(p, cfg, _t(x), _t(t), _t(a), valid, compute_dtype=F32,
                      backend=backend).numpy(), v.numpy())
    reuse = dit.dit_apply(p, cfg, _t(x2), _t(t2), _t(a2), valid,
                          compute_dtype=F32, backend=backend,
                          attn_cache=cache)
    assert_close(reuse, jreuse, atol=2e-4, rtol=1e-4, name="reuse")
    plain = dit.dit_apply(p, cfg, _t(x2), _t(t2), _t(a2), valid,
                          compute_dtype=F32, backend=backend)
    assert (reuse - plain).abs().max() > 1e-5  # fp32 order effects: 1e-7


def test_init_attn_cache(bridged):
    _, _, cfg, p = bridged
    collect, reuse, init = dit.make_pab_fns(cfg, torch.bfloat16)
    cache = init(p, 3, W)
    assert len(cache) == cfg.depth
    for pair in cache:
        for d in pair:
            assert d.shape == (3, W, cfg.grid_h, cfg.grid_w, cfg.hidden_size)
            assert d.dtype == torch.bfloat16 and not d.any()


def _pab_rollouts(bridged, K, steps=6, backend="xla", jdtype=jnp.float32,
                  dtype=F32, n_prompt=3, seed=0):
    """(gtax, port, port exact) make_rollout latents with attention
    broadcast at K, the same injected noise."""
    jcfg, jp, cfg, p = bridged
    if jdtype != jnp.float32:
        jp = jdit.cast_params_for_inference(jp, jdtype)
        p = dit.cast_params_for_inference(p, dtype)
    jfn, tfn = _fns(jcfg, cfg, backend, jdtype, dtype)
    jcf, tcf = _sampler(steps, K)
    n_gen = 3
    prompt, acts = _inputs(seed, 1, n_prompt, n_prompt + n_gen)
    noise = np.random.default_rng(seed + 1).standard_normal(
        (1, n_gen, *LAT)).astype(np.float32)
    with jattn.backend_scope(backend):
        ref = jsd.make_rollout(jfn, W, jcf,
                               pab=jdit.make_pab_fns(jcfg, jdtype))(
            jp, _j(prompt), _j(acts), jax.random.PRNGKey(0),
            num_gen_frames=n_gen, noise=_j(noise))
    pab = dit.make_pab_fns(cfg, dtype, backend)
    args = (p, _t(prompt), _t(acts), None, n_gen)
    got = sd.make_rollout(tfn, W, tcf, pab=pab)(*args, noise=_t(noise))
    exact = sd.make_rollout(tfn, W, dataclasses.replace(
        tcf, attn_broadcast=1))(*args, noise=_t(noise))
    return np.asarray(ref.astype(jnp.float32)), got, exact


@pytest.mark.parametrize("backend", ["xla", "fused_all"])
def test_broadcast_k1_bit_equal_exact(bridged, backend):
    """K=1 with the pab fns is the exact rollout to the bit (gtax pins the
    same, tests/test_sampler.py)."""
    _, got, exact = _pab_rollouts(bridged, 1, backend=backend)
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_broadcast_k2_matches_gtax(bridged, backend):
    """K=2, fp32: against gtax's K=2 at 1e-4, and off the exact rollout
    (the cache is used: a reuse step skips the attention branches)."""
    ref, got, exact = _pab_rollouts(bridged, 2, backend=backend)
    assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert (got - exact).abs().max() > 1e-3


def test_broadcast_k2_bf16_matches_gtax(bridged):
    """K=2 in bf16 compute on `fused_all` (bf16 weights both sides):
    within 2**-5 of the latents' largest magnitude, the card-vs-CPU rule
    for bf16 rollouts (PERF.md §2): gtax's temporal cores round each q.k
    and p.v product to bf16 where the port sums in fp32 (ROADMAP.md §C),
    and those differences pass through every denoise step."""
    ref, got, exact = _pab_rollouts(bridged, 2, backend="fused_all",
                                    jdtype=jnp.bfloat16,
                                    dtype=torch.bfloat16, steps=4)
    scale = max(1.0, float(np.abs(ref).max()))
    assert_close(got, ref, atol=2.0**-5 * scale, rtol=0)
    assert (got - exact).abs().max() > 0


def test_pipelined_broadcast_matches_gtax(bridged):
    """Pipelining + attention broadcast over the full window, P=2, K=2 at 8
    steps (stride 5: calls 1 and 3 reuse the cycle's cache), fp32."""
    jcfg, jp, cfg, p = bridged
    jfn, tfn = _fns(jcfg, cfg, "xla")
    jcf, tcf = _sampler(8, K=2)
    n_gen, B = 3, 1
    prompt, acts = _inputs(11, B, 4, 4 + n_gen)
    key = jax.random.PRNGKey(5)
    ref = jsd.make_pipelined_rollout(jfn, W, jcf, pipeline_depth=2,
                                     pab=jdit.make_pab_fns(jcfg,
                                                           jnp.float32))(
        jp, _j(prompt), _j(acts), key, num_gen_frames=n_gen)
    noise = gtax_draws(key, n_gen + 1, B)
    args = (p, _t(prompt), _t(acts), None, n_gen)
    got = sd.make_pipelined_rollout(tfn, W, tcf, pipeline_depth=2,
                                    pab=dit.make_pab_fns(cfg, F32, "xla"))(
        *args, noise=noise)
    assert_close(got, ref, atol=1e-4, rtol=1e-4)
    plain = sd.make_pipelined_rollout(
        tfn, W, dataclasses.replace(tcf, attn_broadcast=1),
        pipeline_depth=2)(*args, noise=noise)
    assert (got - plain).abs().max() > 1e-3


# ------------------------------------------------------------- renoise

def test_renoise_last_frame_matches_gtax(bridged):
    """gtax's draws (k1, k2 = split(rng): the context noise, the new frame)
    fed to the port; every output within 1e-4."""
    jcfg, jp, cfg, p = bridged
    jfn, tfn = _fns(jcfg, cfg, "xla")
    jcf, tcf = _sampler(4)
    x, _, a = _cases(12)
    rng = jax.random.PRNGKey(9)
    abar, nr = jcf.tables()
    ref = jsd.renoise_last_frame(
        lambda *args: jfn(jp, *args), _j(x), _j(a), rng, jcf, abar, nr)
    k1, k2 = jax.random.split(rng)
    B, T = x.shape[:2]
    tab = tcf.tables()
    got = sd.renoise_last_frame(
        lambda *args: tfn(p, *args), _t(x), _t(a), None, tcf, *tab,
        ctx_noise=_t(jax.random.normal(k1, (B, T - 1, *LAT), jnp.float32)),
        new_frame=_t(jax.random.normal(k2, (B, 1, *LAT), jnp.float32)))
    for name in ("denoised", "x_noisy", "noise", "v"):
        assert_close(got[name], ref[name], atol=1e-4, rtol=1e-4, name=name)
    seeded = sd.renoise_last_frame(lambda *args: tfn(p, *args), _t(x),
                                   _t(a), torch.Generator().manual_seed(0),
                                   tcf, *tab)
    assert seeded["noise"].abs().max() <= tcf.noise_abs_max
    np.testing.assert_array_equal(seeded["x_noisy"][:, -1].numpy(),
                                  seeded["noise"][:, -1].numpy())
