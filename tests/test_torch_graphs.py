"""The compiled rollout on the CPU: the frame plan's body (what a CUDA graph
captures on the card, gtax_torch.sampling.graphs) run eagerly, against
gtax's jitted rollout and against the frame loop it replaced; the body's
freedom from host syncs and host data; the graph cache's key and its
launch accounting (a stub graph: no card here); and the repairs that made
the kernel wrappers safe to capture.

Debug presets (DiT-debug, vae-debug), two threads. Tolerances: fp32
latents within 1e-4 of gtax's (tests/test_torch_serving.py
test_rollout_latents_match_gtax), int8 within tests/test_torch_quant.py's
check_int8 (fp32: 99% of elements within 2e-4, every one within 2**-6 of
the largest magnitude); the plan's body against the pre-slice loop: bit
for bit."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gtax import serving as jserving
from gtax.kernels import attention as jkattn
from gtax.models import vae as jvae
from gtax_torch import serving
from gtax_torch.io import safetensors_port as port
from gtax_torch.kernels import attention as kattn
from gtax_torch.kernels import block, capture
from gtax_torch.models import dit
from gtax_torch.sampling import diffusion as sd
from gtax_torch.sampling import graphs
from tests.conftest import assert_close
from tests.test_torch_models import _gtax_debug_params
from tests.test_torch_quant import check_int8

torch.set_num_threads(2)

KW = dict(dtype="float32", noise_steps=3, dit_model="DiT-debug",
          vae_model="vae-debug")
FORMS = {"incremental": {}, "full_window": {"incremental": False}}
# the exact rollout's forms and backends: (ServingConfig changes)
BODIES = {"fused": {}, "fused_all": {"attention_backend": "fused_all"},
          "full_window": {"incremental": False},
          "xla": {"attention_backend": "xla"},
          "pallas": {"attention_backend": "pallas"},
          "fused_mlp": {"attention_backend": "fused_mlp"},
          "no_cond_cache": {"cond_cache": False},
          "stacked": {"unstack": False},
          "int8": {"quantize": "int8"},
          "int8_full_window": {"quantize": "int8", "incremental": False}}


@pytest.fixture(autouse=True)
def interpret_mode():
    jkattn.set_interpret(True)
    yield
    jkattn.set_interpret(None)


@pytest.fixture(scope="module")
def weights():
    """(gtax DiT params, gtax VAE params), numpy, nonzero adaLN heads."""
    _, jdit_params = _gtax_debug_params()
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jv = jax.tree.map(lambda l: np.asarray(l + 0.01 if l.ndim == 1 else l),
                      jv)
    return jdit_params, jv


def _port(weights, **changes):
    jdit_params, jv = weights
    return serving.VideoGenerator(
        port.dit_from_gtax(jdit_params), port.vae_from_gtax(jv),
        serving.ServingConfig(**dict(KW, **changes)), device="cpu")


def _inputs(seed, n_prompt=3, n_gen=3):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, n_prompt, 8, 6, 8)).astype(np.float32)
    noise = rng.standard_normal((1, n_gen, 8, 6, 8)).astype(np.float32)
    acts = rng.standard_normal((1, n_prompt + n_gen, 25)).astype(np.float32)
    return lat, acts, noise


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("form", list(FORMS))
def test_frame_plan_rollout_matches_gtax(weights, form, quantize):
    """VideoGenerator's rollout (the frame plan's body, eager on the CPU)
    against gtax's jitted rollout with the same injected noise; three
    prompt latents, so the first window has a padded slot."""
    jdit_params, jv = weights
    changes = dict(FORMS[form], quantize=quantize)
    jgen = jserving.VideoGenerator(
        jax.tree.map(jnp.asarray, jdit_params), jax.tree.map(jnp.asarray, jv),
        jserving.ServingConfig(**dict(KW, **changes)))
    gen = _port(weights, **changes)
    lat, acts, noise = _inputs(1)
    ref = jgen._rollout(jgen.dit_params, jnp.asarray(lat), jnp.asarray(acts),
                        jax.random.PRNGKey(0), num_gen_frames=3,
                        noise=jnp.asarray(noise))
    got = gen._rollout(gen.dit_params, torch.from_numpy(lat),
                       torch.from_numpy(acts), None, 3,
                       noise=torch.from_numpy(noise))
    assert isinstance(gen._rollout.graphs, graphs.FrameGraphs)
    if quantize == "int8":
        check_int8(got, np.asarray(ref), name=form)
    else:
        assert_close(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


def _loop(dit_fn, x, actions, valid, cfg, abar, noise_range, cond=None,
          incremental=None):
    """The exact rollout's frame as the sampler ran it before the frame
    plan (denoise_window with cond / incremental), kept as the reference:
    the window with its last frame denoised."""
    if cond is None:
        for noise_idx in range(cfg.ddim_noise_steps, -1, -1):
            x_pred, _ = sd.denoise_step(dit_fn, x, actions, valid, noise_idx,
                                        cfg.stabilization_level, noise_range,
                                        abar)
            x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
        return x
    cond_fn, apply_fn = cond
    B, T = x.shape[:2]
    steps = cfg.ddim_noise_steps
    n_lv = steps + 1
    t_stab = torch.full((B, T), cfg.stabilization_level, dtype=torch.int32)
    mods_ctx = cond_fn(t_stab, actions)
    idxs = list(range(steps, -1, -1))
    t_last = torch.from_numpy(np.repeat(noise_range[idxs].astype(np.int32),
                                        B)).reshape(n_lv * B, 1)
    a_last = None
    if actions is not None:
        a_last = actions[None, :, -1:, :].expand(
            n_lv, B, 1, actions.shape[-1]).reshape(n_lv * B, 1, -1)
    mods_all = sd._rows(cond_fn(t_last, a_last),
                        lambda m: m.reshape((n_lv, B) + m.shape[1:]))
    if incremental is not None:
        prefill_fn, step_fn = incremental
        kv = prefill_fn(x[:, :-1], sd._rows(mods_ctx, lambda m: m[:, :-1]),
                        valid[:-1])
        x_last = x[:, -1:]
        for k, noise_idx in enumerate(idxs):
            v = step_fn(x_last, kv, sd._rows(mods_all, lambda m: m[k]),
                        valid).float()
            curr = int(noise_range[noise_idx])
            nxt = int(noise_range[max(noise_idx - 1, 0)])
            x_last = sd._ddim_update(x_last, v, abar[curr], abar[nxt],
                                     noise_idx)
        return torch.cat([x[:, :-1], x_last], dim=1)
    for k, noise_idx in enumerate(idxs):
        mods = {"blocks": [{key: torch.cat([w[key][:, :-1], lr[key][k]],
                                           dim=1) for key in w}
                           for w, lr in zip(mods_ctx["blocks"],
                                            mods_all["blocks"])],
                "final": torch.cat([mods_ctx["final"][:, :-1],
                                    mods_all["final"][k]], dim=1)}

        def call(xx, tt, aa, vv, mods=mods):
            return apply_fn(xx, mods, vv)

        x_pred, _ = sd.denoise_step(call, x, actions, valid, noise_idx,
                                    cfg.stabilization_level, noise_range,
                                    abar)
        x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
    return x


def _plan(gen, valid, actions=True):
    """gen's rollout's frame plan for a B=1 window, and its functions."""
    g = gen
    sampler = sd.SamplerConfig(ddim_noise_steps=g.cfg.noise_steps,
                               schedule_clamp_min=1e-4)
    dt, backend = g._dtype, g.cfg.attention_backend

    def dit_fn(params, x, t, a, v):
        return dit.dit_apply(params, g.dit_cfg, x, t, a, v,
                             compute_dtype=dt, backend=backend)

    cond = inc = None
    if g.cfg.unstack and g.cfg.cond_cache:
        cond = dit.make_cond_fns(g.dit_cfg, dt, backend)
        if g.cfg.incremental and backend in ("fused", "fused_all"):
            inc = dit.make_incremental_fns(g.dit_cfg, dt)
    abar, noise_range = sampler.tables()
    plan = sd.FramePlan((dit_fn, cond, inc), sampler, abar, noise_range, 1,
                        5, valid, (25, torch.float32) if actions else None,
                        "cpu")
    return plan, (dit_fn, cond, inc), sampler, abar, noise_range


def _bind(params, fns):
    dit_fn, cond, inc = fns
    bound = (lambda x, t, a, v: dit_fn(params, x, t, a, v),)
    bound += (None if cond is None else (
        lambda t, a: cond[0](params, t, a),
        lambda x, m, v: cond[1](params, x, m, v)),)
    bound += (None if inc is None else (
        lambda xc, mc, vc: inc[0](params, xc, mc, vc),
        lambda xl, kv, ml, vv: inc[1](params, xl, kv, ml, vv)),)
    return bound


def _window(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 5, 8, 6, 8)).astype(
        np.float32))
    awin = torch.from_numpy(rng.standard_normal((1, 5, 25)).astype(
        np.float32))
    return x, awin


@pytest.mark.parametrize("valid", [(True,) * 5, (False, True, True, True,
                                                 True)], ids=["full", "pad"])
@pytest.mark.parametrize("body", list(BODIES))
def test_plan_body_bit_equal_to_loop(weights, body, valid):
    """FramePlan.frame gives the bits of the frame loop it replaced, in
    every form, backend and quantization of the exact rollout."""
    gen = _port(weights, **BODIES[body])
    plan, fns, sampler, abar, noise_range = _plan(gen, valid)
    x, awin = _window(3)
    got = plan.frame(gen.dit_params, x[:, :-1], x[:, -1:], awin)
    dit_fn, cond, inc = _bind(gen.dit_params, fns)
    ref = _loop(dit_fn, x, awin, torch.tensor(valid), sampler, abar,
                noise_range, cond, inc)
    assert torch.equal(got, ref[:, -1:])


class _HostTraffic(TorchDispatchMode):
    """Records the ops that wait on a tensor's value on the host
    (_local_scalar_dense: .item(), bool(), ...) or make a tensor from host
    data (lift_fresh: torch.tensor, as_tensor of a list, from_numpy)."""

    FLAGGED = ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.FLAGGED:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("body", list(BODIES))
def test_frame_body_makes_no_host_sync_or_host_data(weights, body):
    """After one warm-up frame (as the capture's), the body dispatches no
    _local_scalar_dense and makes no tensor from host data: on the card it
    would wait on the card or copy from the host."""
    gen = _port(weights, **BODIES[body])
    plan = _plan(gen, (False, True, True, True, True))[0]
    x, awin = _window(4)
    args = (gen.dit_params, x[:, :-1], x[:, -1:], awin)
    warm = plan.frame(*args)
    with _HostTraffic() as mode:
        again = plan.frame(*args)
    assert mode.seen == []
    assert torch.equal(warm, again)


def test_graph_key_separates_what_a_capture_bakes_in(weights):
    """FrameGraphs' key separates B, valid bits, actions, dtype, quantize,
    backend, noise steps and the params' identity, and an equal frame gives
    an equal key."""
    gen = _port(weights)
    sampler = sd.SamplerConfig(ddim_noise_steps=3)
    abar, noise_range = sampler.tables()

    def plan(B=1, valid=(True,) * 5, actions=(25, torch.float32)):
        return sd.FramePlan((None, None, None), sampler, abar, noise_range,
                            B, 5, valid, actions, "cpu")

    def key(p=None, params=None, **static):
        s = dict(dtype=torch.bfloat16, quantize="none", backend="fused",
                 noise_steps=3)
        s.update(static)
        return graphs.FrameGraphs(**s).key(
            p or plan(), gen.dit_params if params is None else params)

    base = key()
    assert key() == base and key(plan()) == base
    others = [key(plan(B=2)), key(plan(valid=(False,) + (True,) * 4)),
              key(plan(actions=None)), key(dtype=torch.float32),
              key(quantize="int8"), key(backend="pallas"),
              key(noise_steps=4), key(params=dict(gen.dit_params))]
    assert all(k != base for k in others)
    assert len(set(others)) == len(others)


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay writes 2 * ctx's sum
    into the static output."""

    def __init__(self, inputs, out):
        self.inputs, self.out, self.replays = inputs, out, 0

    def replay(self):
        self.replays += 1
        self.out.fill_(2 * float(self.inputs[0].sum()))


def test_replay_adds_the_captured_launches_once():
    """Launches a wrapper makes while its thread records a capture go to
    the capture's scope, not to its counter (the warm-up's, made before
    the recording, do); each replay adds the recorded ones once; the
    static inputs are written and the output copied out."""
    fns = (block.fused_spatial_branch, kattn.fused_sdpa)
    start = {fn: fn.launches for fn in fns}
    with capture.scope() as scope:
        capture.launched(block.fused_spatial_branch)  # the warm-up's
        scope.recording = True
        for fn, n in zip(fns, (16, 3)):
            for _ in range(n):
                capture.launched(fn)
    assert block.fused_spatial_branch.launches == start[fns[0]] + 1
    assert kattn.fused_sdpa.launches == start[fns[1]]
    assert scope.launches == {block.fused_spatial_branch: 16,
                              kattn.fused_sdpa: 3}
    inputs = (torch.zeros(2), torch.zeros(1), None)
    out = torch.zeros(1)
    stub = _StubGraph(inputs, out)
    frame = graphs.FrameGraph(stub, inputs, out,
                              tuple(scope.launches.items()), params={})
    for n in (1, 2):
        got = frame.replay(torch.full((2,), float(n)), torch.ones(1), None)
        assert stub.replays == n
        assert got.item() == 4.0 * n and got is not out
        assert block.fused_spatial_branch.launches == (
            start[fns[0]] + 1 + 16 * n)
        assert kattn.fused_sdpa.launches == start[fns[1]] + 3 * n
    for fn, n in start.items():
        fn.launches = n


def test_capture_scope_is_the_capturing_threads_own(monkeypatch):
    """A capture recorded on one thread takes nothing from the launches
    another thread makes meanwhile (prewarm captures from a thread of its
    own), and that thread's buffers are not the scope's; one scope at a
    time a thread."""
    monkeypatch.setattr(capture, "_HELD", {})
    fn = block.fused_mlp_branch
    start = fn.launches
    seen = {}

    def zeros(device):
        return torch.zeros(4, device=device)

    def other():
        for _ in range(5):
            capture.launched(fn)
        seen["buffer"] = capture.owned("test_buffer", "cpu", zeros)

    with capture.scope() as scope:
        scope.recording = True
        mine = capture.owned("test_buffer", "cpu", zeros)
        t = threading.Thread(target=other)
        t.start()
        t.join()
        capture.launched(fn)
        with pytest.raises(RuntimeError, match="open"):
            with capture.scope():
                pass
    assert fn.launches == start + 5 and scope.launches == {fn: 1}
    assert seen["buffer"] is not mine
    assert scope.buffers == {("test_buffer", torch.device("cpu")): mine}
    assert capture.owned("test_buffer", "cpu", zeros) is seen["buffer"]
    fn.launches = start


class _Plan:
    def __init__(self, family, valid_key):
        self.family, self.valid_key = family, valid_key


def test_graph_cache_captures_once_a_key_least_recent_out(monkeypatch):
    """FrameGraphs.run captures at a frame key's first frame (whose result
    is the warm-up's) and replays after, into one pool and on one stream
    for the cache. A family (B, actions, params) keeps every graph it
    captured: the W - 1 valid patterns of a request from one prompt
    frame. Requests that alternate between two families capture each
    frame once; past FAMILIES families the least recently used goes
    whole."""
    captured, pools = [], []

    def capture_stub(plan, params, ctx, fresh, awin, pool, stream):
        captured.append((plan.family, plan.valid_key))
        pools.append((pool, stream))
        inputs = (ctx.clone(), fresh.clone(), None)
        out = torch.zeros(1)
        return torch.full((1,), -1.0), graphs.FrameGraph(
            _StubGraph(inputs, out), inputs, out, (), params)

    monkeypatch.setattr(graphs, "capture", capture_stub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
    monkeypatch.setattr(graphs, "FAMILIES", 2)
    cache = graphs.FrameGraphs(torch.float32, "none", "fused", 3)
    ctx, fresh, params = torch.ones(3), torch.ones(1), {}
    W = 5

    def request(family, n_gen=6, n_prompt=1):
        outs = []
        for s in range(n_gen):
            i = n_prompt + s
            valid = tuple(i - (W - 1) + j >= 0 for j in range(W))
            outs.append(cache.run(_Plan(family, valid), params, ctx, fresh,
                                  None).item())
        return outs

    assert request("actions") == [-1.0] * 4 + [6.0] * 2
    assert len(captured) == W - 1
    assert request("actions") == [6.0] * 6
    request("none")
    for _ in range(2):
        assert request("actions") == [6.0] * 6
        assert request("none") == [6.0] * 6
    assert len(captured) == 2 * (W - 1)
    assert len(cache.graphs()) == 2 * (W - 1)
    assert all(p == (cache.pool, cache.stream) for p in pools)
    assert cache.pool is not None and cache.stream is not None
    request("B2")  # "actions", the least recently used, goes whole
    assert {fam for fam, _ in cache.graphs()} == {
        cache.family(_Plan(f, None), params) for f in ("none", "B2")}
    request("actions")
    assert len(captured) == 4 * (W - 1)


def _capturing(monkeypatch):
    monkeypatch.setattr(capture, "capturing", lambda device: True)


def test_temporal_bias_made_once_per_mask_and_device(monkeypatch):
    """temporal_bias is gtax's temporal_preamble mask, made once per valid
    mask and device and kept; a new mask inside a capture raises."""
    T = 5
    valid = [False, True, True, True, True]
    a = block.temporal_bias(valid, T, "cpu")
    assert block.temporal_bias(torch.tensor(valid), T, "cpu") is a
    ok = torch.tensor(valid)
    allow = torch.tril(torch.ones(T, T, dtype=torch.bool)) & (
        ok[None, :] | torch.eye(T, dtype=torch.bool))
    assert torch.equal(a, torch.where(allow, 0.0, -1e30).float())
    b = block.temporal_bias(None, T, "cpu")
    assert b is not a and block.temporal_bias([True] * T, T, "cpu") is b
    _capturing(monkeypatch)
    assert block.temporal_bias(valid, T, "cpu") is a
    with pytest.raises(RuntimeError, match="capture"):
        block.temporal_bias([False, False, True, True, True], T, "cpu")


def test_attention_bias_kept_and_not_filled_inside_a_capture(monkeypatch):
    """A host mask's bias is made once per mask, kept (a graph may hold
    its address), and a new one is refused inside a capture."""
    mask = torch.tensor([True, False, True])
    a = kattn.build_bias(3, mask, causal=True)
    assert kattn.build_bias(3, mask.clone(), causal=True) is a
    assert kattn.build_bias(3, mask, causal=False) is not a
    _capturing(monkeypatch)
    assert kattn.build_bias(3, mask, causal=True) is a
    with pytest.raises(RuntimeError, match="capture"):
        kattn.build_bias(3, torch.tensor([False, True, True]))


def test_f32_flags_never_replaced_while_held(monkeypatch):
    """The persistent fp32 GEMM's counters: one zeroed buffer of
    F32_FLAGS_WORDS a device and stream, made once and never replaced
    whatever (M, N) asks (a graph may hold its address), a shape past it
    refused; in a capture scope the scope's own (its graph holds them, and
    no other launch shares them with its replays), made in the warm-up,
    never inside the capture."""
    monkeypatch.setattr(block, "_stream", lambda t: 12345)
    monkeypatch.setattr(capture, "_HELD", {})
    a = torch.zeros(1)
    flags = block._f32_flags(a, 48, 128)
    assert flags.numel() == block.F32_FLAGS_WORDS and not flags.any()
    assert block._f32_flags(a, 431, 6144) is flags
    with pytest.raises(ValueError, match="tile counters"):
        block._f32_flags(a, 48 * 400, 128 * 50)
    with capture.scope() as scope:
        own = block._f32_flags(a, 144, 4096)
        assert own is not flags and not own.any()
        assert block._f32_flags(a, 288, 1024) is own
    assert list(scope.buffers.values()) == [own]
    assert block._f32_flags(a, 144, 4096) is flags
    _capturing(monkeypatch)
    assert block._f32_flags(a, 144, 4096) is flags
    with capture.scope():
        with pytest.raises(RuntimeError, match="capture"):
            block._f32_flags(a, 144, 4096)


def test_constant_made_under_inference_mode_serves_autograd():
    """A held constant first asked for by a generate (inference mode) is a
    normal tensor: a later training step's autograd may save it (the `xla`
    temporal mask under torch.where)."""
    with torch.inference_mode():
        made = torch.tensor([True, False, True])
        mask = capture.held(("test_mask", 3), "cpu", made.to)
    assert not mask.is_inference()
    x = torch.ones(3, requires_grad=True)
    torch.where(mask, x * 2.0, -1e30).sum().backward()
    assert torch.equal(x.grad, torch.tensor([2.0, 0.0, 2.0]))
