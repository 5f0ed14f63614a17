"""The compiled rollout: one CUDA graph a generated frame (the counterpart
of gtax's `jax.jit` of make_rollout, gtax/sampling/diffusion.py:314, whose
frames and noise steps are nested lax.scans).

FrameGraphs caches, by everything the captured launches bake in (the
frame plan's key, dtype, quantize, backend, noise_steps and the identity
of the params), one FrameGraph: the CUDA graph of a FramePlan's frame
body (dit_cond's rows, dit_prefill of the context and the noise steps'
dit_apply_step calls with their DDIM updates; or the full window's
dit_apply calls) over three static inputs, ctx, fresh and awin, and one
static output, the denoised last frame. A frame then costs three small
copies, one replay and one copy out.

Capture: the plan's first frame runs eagerly on a side stream (the warm-up,
whose result is that frame's: every library load, cudaFuncSetAttribute and
cached constant happens there), then torch.cuda.graph captures the body on
the same stream into the cache's memory pool, under capture_error_mode
"thread_local" (VideoGenerator.prewarm captures from its thread while the
caller's may touch the card). A failed capture or replay raises: nothing
falls back to the eager frame. The params are read in place: a graph sees
their leaves' new values, but not a leaf replaced by another tensor (that
needs a new params dict).

The cache: a family is the frames of one (B, latent shape, actions,
params); its graphs differ only in the valid slots, of which a window of W
frames has at most W - 1 patterns (a rollout from p < W - 1 prompt frames
meets the patterns of frames p to W - 2, then the steady one). A family
keeps every graph it captured, and the cache keeps FAMILIES families, the
least recently used out first, so that a server whose requests alternate
(actions or none, one batch size or two) captures each frame once. All of
a cache's graphs share one memory pool, captured on one stream of the
cache's: they replay one at a time on one stream (the generator's lock),
each output copied out before the next replay, so a graph's intermediates
may lie where another's did; only the static inputs and outputs are a
graph's own.

Launch accounting: a capture launches nothing. The wrappers count the
launches they make inside it in the capture's scope (kernels/capture.py,
per thread), not in their `.launches`, and each replay adds those counts
once. The persistent fp32 GEMM's tile counters are the capture's own too
(capture.owned), held by its FrameGraph.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import time

import torch

from gtax_torch.kernels import capture as kcapture

# families a cache keeps, least recently used out first: one for each live
# (B, actions) pair of a server's traffic, with room for two batch sizes
FAMILIES = 4


def frame_key(plan_family, params, dtype, quantize, backend, noise_steps):
    """A family's key: what its captured frames bake in beyond their three
    inputs and the valid slots."""
    return (plan_family, str(dtype), quantize, backend, noise_steps,
            id(params))


class FrameGraph:
    """A captured frame: its graph, static inputs (ctx, fresh, awin or
    None) and output, the launches it records, what it holds for its
    launches (the params, its plan, the buffers its capture owns), and its
    capture figures (`stats`: capture_ms, instantiate_ms, nodes,
    pool_bytes: the shared pool's growth at this capture)."""

    def __init__(self, graph, inputs, out, launches, params, stats=None,
                 plan=None, buffers=None):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.launches = launches
        self.params = params  # held: the key has its id
        self.plan, self.buffers = plan, buffers
        self.stats = stats or {}

    def replay(self, *inputs):
        with torch.inference_mode():
            for dst, src in zip(self.inputs, inputs):
                if dst is not None:
                    dst.copy_(src)
            self.graph.replay()
            for fn, n in self.launches:
                fn.launches += n
            return self.out.clone()


def _capture_nodes(stream) -> int | None:
    """The nodes of the graph being captured on `stream` (libcuda's
    cuStreamGetCaptureInfo_v2 and cuGraphGetNodes); None where libcuda
    does not say."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        info, get_nodes = cuda.cuStreamGetCaptureInfo_v2, cuda.cuGraphGetNodes
    except (OSError, AttributeError):
        return None
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    gid, n_deps = ctypes.c_ulonglong(), ctypes.c_size_t()
    deps, nodes = ctypes.c_void_p(), ctypes.c_size_t()
    if info(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
            ctypes.byref(gid), ctypes.byref(graph), ctypes.byref(deps),
            ctypes.byref(n_deps)) or get_nodes(graph, None,
                                               ctypes.byref(nodes)):
        return None
    return nodes.value


def capture(plan, params, ctx, fresh, awin, pool, side):
    """(the frame's result, its FrameGraph): the warm-up frame, then the
    capture into `pool`, on the side stream `side`, in one capture
    scope."""
    dev = ctx.device
    main = torch.cuda.current_stream(dev)
    with torch.inference_mode(), kcapture.scope() as scope:
        inputs = tuple(None if t is None else t.clone()
                       for t in (ctx, fresh, awin))
        side.wait_stream(main)
        with torch.cuda.stream(side):
            x_last = plan.frame(params, *inputs)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # what torch.cuda.graph does on entry, done first so that the
        # memory it frees does not count against the pool
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        scope.recording = True
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            out = plan.frame(params, *inputs)
            nodes = _capture_nodes(side)
        scope.recording = False
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
    stats = {"capture_ms": (t1 - t0) * 1e3, "instantiate_ms": (t2 - t1) * 1e3,
             "nodes": nodes,
             "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}
    main.wait_stream(side)
    x_last.record_stream(main)
    return x_last, FrameGraph(graph, inputs, out,
                              tuple(scope.launches.items()), params, stats,
                              plan, scope.buffers)


class FrameGraphs:
    """The graph cache of one rollout (make_rollout(graphs=)): `run` replays
    the frame's graph, capturing it at the first frame of its key."""

    def __init__(self, dtype, quantize, backend, noise_steps):
        self.static = (dtype, quantize, backend, noise_steps)
        self.cache = collections.OrderedDict()  # family -> {valid: graph}
        # the memory pool all the cache's graphs share, and the one stream
        # they are captured on (the allocator reuses a freed block only on
        # the stream that allocated it)
        self.pool = self.stream = None

    def family(self, plan, params):
        return frame_key(plan.family, params, *self.static)

    def key(self, plan, params):
        return self.family(plan, params), plan.valid_key

    def graphs(self):
        """key -> FrameGraph of every graph the cache holds."""
        return {(fam, valid): g for fam, held in self.cache.items()
                for valid, g in held.items()}

    def run(self, plan, params, ctx, fresh, awin):
        fam = self.family(plan, params)
        held = self.cache.setdefault(fam, {})
        self.cache.move_to_end(fam)
        while len(self.cache) > FAMILIES:
            self.cache.popitem(last=False)
        entry = held.get(plan.valid_key)
        if entry is not None:
            return entry.replay(ctx, fresh, awin)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(ctx.device)
        x_last, held[plan.valid_key] = capture(
            plan, params, ctx, fresh, awin, self.pool, self.stream)
        return x_last
