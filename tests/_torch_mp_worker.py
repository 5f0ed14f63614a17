"""One rank of tests/test_torch_multiproc.py's two-process groups: the port
over gloo on the CPU, imported without JAX.

    python tests/_torch_mp_worker.py <case> <rank> <world> <dir>

The rank joins the group through a file:// store in <dir> (explicitly, or
through gtax's GTAX_* environment when the parent set it), reads the
parent's inputs from <dir>/inputs.pt, runs <case> and writes what it saw to
<dir>/out_<rank>.pt. A rank that fails exits nonzero; the parent then
stops the other.
"""

import json
import os
import sys

import torch

torch.set_num_threads(1)

TIMEOUT_S = 60  # a dead peer fails the collective here, not in 30 min


def _flat(params):
    from gtax_torch.train import checkpoint as ckpt

    return {k: v.detach().clone() for k, v in ckpt.flat(params).items()}


def _debug_trainer(config, **kw):
    from gtax_torch.models import dit, vae
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer

    return Trainer(TrainingConfig.from_dict(config), dit_cfg=dit.DiT_debug(),
                   vae_cfg=vae.VAE_debug(), device="cpu", **kw)


def dp_train(rank, world, d, inp):
    """Two steps of the data-parallel trainer on this rank's rows of the
    parent's global latent batch, with the parent's global loss draws (the
    trainer keeps its rows of them). Rank 1 starts from other weights: the
    broadcast at construction makes them rank 0's."""
    from gtax_torch.data.loader import Batch
    from gtax_torch.train import trainer as trainer_mod

    B = inp["config"]["batch_size"]

    def draws(latents, cfg, generator, batch=None):
        assert batch == B * world, batch
        return inp["draws"]

    trainer_mod.draw_loss_noise = draws
    params = inp["params"]
    if rank > 0:
        from gtax_torch.models import dit

        params = dit._map_params(params, lambda _, a: 2 * a + 1)
    tr = _debug_trainer(inp["config"], total_dataset_size=64,
                        dit_params=params, vae_params=inp["vae"])
    rows = slice(rank * B, (rank + 1) * B)
    batch = Batch(inp["latents"][:, rows], inp["actions"][:, rows],
                  is_latents=True)
    steps = [tr.train_step_sync(batch) for _ in range(2)]
    return {"loss": [m["train_loss"] for m in steps],
            "grad_norm": [m["grad_norm"] for m in steps],
            "masters": _flat(tr.dit_params), "world": tr.world,
            "steps_per_epoch": tr.steps_per_epoch}


def dp_ckpt(rank, world, d, inp):
    """Steps 1-3 through the training loop with a save at step 2, then a
    second trainer resumes from it into step 3 (build_loaders' per-rank
    stride of a dummy dataset). Returns both runs' step-3 loss and masters,
    the files the save wrote and the metrics file after the first run."""
    import torch.distributed as dist

    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import build_loaders

    config = inp["config"]
    runs = []
    for _ in range(2):
        train, _ = build_loaders(TrainingConfig.from_dict(config), size=24)
        tr = _debug_trainer(config, total_dataset_size=len(train.dataset))
        seen = {}
        tr.training_loop(train, None, callbacks=[
            lambda t, m: seen.update({m["step"]: m["train_loss"]})])
        runs.append((seen, _flat(tr.dit_params), tr.skip_batches))
        if len(runs) == 1:
            dist.barrier()
            with open(os.path.join(config["output_dir"],
                                   "m_metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
    out = config["output_dir"]
    ckpt_dir = os.path.join(out, "train_checkpoints", "m_last")
    return {"loss_a": runs[0][0], "loss_b": runs[1][0],
            "final_a": runs[0][1], "final_b": runs[1][1],
            "skip_b": runs[1][2], "records": records,
            "exports": sorted(f for f in os.listdir(out)
                              if f.endswith(".safetensors")),
            "states": sorted(os.listdir(ckpt_dir))}


def cursor(rank, world, d, inp):
    """Each rank streams its own tar shard (unequal lengths), stops after a
    rank-dependent count, saves a checkpoint; a new trainer and dataset
    resume from it. Returns the uninterrupted stream, the resumed one and
    step.json."""
    from gtax_torch.data.common import ClipTransform
    from gtax_torch.data.webtar import WebTarDataset

    kw = dict(split="train", return_actions=False, shards=inp["shards"],
              shuffle_shards=False, shuffle_buffer=1, resampled=True,
              worker_index=rank, num_workers=world,
              transform=ClipTransform(target_h=36, target_w=64))

    def take(ds, n):
        out, it = [], iter(ds)
        for item in it:
            out.append(torch.from_numpy(item["video"]))
            if len(out) == n:
                break
        it.close()
        return out

    whole = take(WebTarDataset(**kw), 12)
    k = inp["stop_at"][rank]
    ds = WebTarDataset(**kw)
    take(ds, k)
    tr = _debug_trainer(inp["config"], total_dataset_size=64)
    tr.train_dataset = ds
    tr.save_checkpoint(0)
    resumed = WebTarDataset(**kw)
    tr2 = _debug_trainer(inp["config"], total_dataset_size=64)
    tr2.train_dataset = resumed
    tr2.try_resume()
    with open(os.path.join(tr._ckpt_dir(), "step.json")) as f:
        meta = json.load(f)
    return {"whole": whole, "k": k, "resumed": take(resumed, 6),
            "cursors": meta.get("data_cursors")}


def _serving_cfg(**kw):
    from gtax_torch import serving

    return serving.ServingConfig(dtype="float32", noise_steps=3,
                                 dit_model="DiT-debug",
                                 vae_model="vae-debug", **kw)


def dp_serve_one(rank, world, inp):
    """Before the group: this process's one-rank generate of this rank's
    rows with this rank's seed, fp32 and int8."""
    from gtax_torch import serving
    from gtax_torch.parallel import mesh

    per = inp["video"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    out = {}
    for quantize in ("none", "int8"):
        one = serving.VideoGenerator(inp["params"], inp["vae"],
                                     _serving_cfg(quantize=quantize),
                                     device="cpu")
        out[quantize] = torch.from_numpy(one.generate(
            inp["video"][rows], inp["actions"][rows], num_frames=6,
            seed=mesh.rank_seed(11, rank)))
    return out


def dp_serve(rank, world, d, inp, one):
    """ServingConfig(mesh_data=2) over the parent's global batch, fp32 and
    int8 (the plain paths), against `one` (dp_serve_one); and what it
    refuses: noise=, a batch that does not divide, a 1x1 mesh in the
    group."""
    from gtax_torch import serving

    out = {}
    for quantize in ("none", "int8"):
        gen = serving.VideoGenerator(
            inp["params"], inp["vae"],
            _serving_cfg(quantize=quantize, mesh_data=2), device="cpu")
        got = gen.generate(inp["video"], inp["actions"], num_frames=6,
                           seed=11)
        out[quantize] = (torch.from_numpy(got), one[quantize])
    refused = []
    for kw in ({"noise": torch.zeros(4, 2, 8, 6, 8)},
               {"prompt_frames": inp["video"][:3],
                "actions": inp["actions"][:3]}):
        call = {"prompt_frames": inp["video"], "actions": inp["actions"],
                "num_frames": 6, **kw}
        try:
            gen.generate(**call)
        except ValueError as e:
            refused.append(str(e))
    try:
        serving.VideoGenerator(inp["params"], inp["vae"], _serving_cfg(),
                               device="cpu")
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = refused
    out["mesh"] = gen.mesh.shape
    return out


def _rollout(gen, inp):
    with torch.inference_mode():
        return gen._rollout(gen.dit_params, inp["prompt"], inp["actions"],
                            None, num_gen_frames=2, noise=inp["noise"])


def tp_serve_one(rank, world, inp):
    """Before the group: the one-process `xla` rollout on the parent's
    injected noise, in both layouts."""
    from gtax_torch import serving

    return {unstack: _rollout(serving.VideoGenerator(
        inp["params"], inp["vae"], _serving_cfg(
            unstack=unstack, attention_backend="xla"), device="cpu"), inp)
        for unstack in (True, False)}


def tp_serve(rank, world, d, inp, one):
    """ServingConfig(mesh_model=2) in both layouts: the rollout's latents
    on the parent's injected noise, `one`'s (tp_serve_one), and the pixels
    of a seeded generate."""
    from gtax_torch import serving

    out = {}
    for unstack in (True, False):
        tp = serving.VideoGenerator(
            inp["params"], inp["vae"],
            _serving_cfg(mesh_model=2, unstack=unstack), device="cpu")
        lat = _rollout(tp, inp)
        pixels = tp.generate(inp["video"], inp["actions"], num_frames=4,
                             seed=3)
        qkv = tp.dit_params["blocks"]
        qkv = (qkv if isinstance(qkv, dict) else qkv[0])["s_attn"]["qkv"]
        out["unstacked" if unstack else "stacked"] = {
            "tp": lat, "one": one[unstack],
            "pixels": torch.from_numpy(pixels),
            "backend": tp._backend, "qkv_cols": qkv["kernel"].shape[-1]}
    return out


def _whole_grads(tr):
    """Each leaf's gradient of the last step as the optimizer read it
    (summed over the data axis, / accumulation x data size), gathered
    whole over the model axis."""
    from gtax_torch.parallel import mesh
    from gtax_torch.train.optim import leaves

    scale = tr.config.gradient_accumulation_steps * tr.world
    out = {}
    for path, p in leaves(tr.dit_params):
        if p.grad is not None:
            g = p.grad / scale
            if tr.tp is not None:
                g = mesh.gather_leaf(path, g, tr.tp)
            out["/".join(map(str, path))] = g
    return out


def tp_train(rank, world, d, inp):
    """One step of the tensor-parallel trainer under each of the parent's
    backends (and int8_forward), on this data index's rows of the global
    latent batch and of the parent's global draws: the loss, grad norm,
    every leaf's gradient and the masters after the update, gathered
    whole."""
    from gtax_torch.data.loader import Batch
    from gtax_torch.parallel import mesh
    from gtax_torch.train import trainer as trainer_mod

    B = inp["config"]["batch_size"]
    loss = trainer_mod.diffusion_forcing_loss
    out = {}
    for name, over in inp["runs"].items():
        cfg = dict(inp["config"], **over)
        data = world // cfg["mesh_model"]
        tr = _debug_trainer(cfg, total_dataset_size=64,
                            dit_params=inp["params"], vae_params=inp["vae"])
        rows = mesh.process_batch_slice(B * data, tr.mesh.data)
        mine = {k: v[:, rows] for k, v in inp["draws"].items()}
        trainer_mod.diffusion_forcing_loss = (
            lambda fn, la, ac, gen, *a, draws=None: loss(
                fn, la, ac, None, *a, draws=mine))
        gathers = []  # the step's all-gathers over the model axis
        all_gather = mesh.Axis.all_gather
        mesh.Axis.all_gather = (lambda self, *a, **k: gathers.append(1)
                                or all_gather(self, *a, **k))
        try:
            m = tr.train_step_sync(Batch(inp["latents"][:, rows],
                                         inp["actions"][:, rows],
                                         is_latents=True))
        finally:
            mesh.Axis.all_gather = all_gather
        out[name] = {"loss": m["train_loss"], "grad_norm": m["grad_norm"],
                     "grads": _whole_grads(tr),
                     "masters": _flat(mesh.gather_params(tr.dit_params,
                                                         tr.mesh)),
                     "mesh": tr.mesh.shape, "rank_data": tr.rank,
                     "gathers": len(gathers),
                     "qkv_cols": tr.dit_params["blocks"][0]["s_attn"][
                         "qkv"]["kernel"].shape[-1]}
    return out


def tp_ckpt(rank, world, d, inp):
    """dp_ckpt's run under the parent's mesh: steps 1-3 through the
    training loop with a save at step 2, then a second trainer resumes from
    it into step 3 (gathered masters of both runs)."""
    from gtax_torch.parallel import mesh
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import build_loaders

    config = inp["config"]
    runs = []
    for _ in range(2):
        train, _ = build_loaders(TrainingConfig.from_dict(config), size=24)
        tr = _debug_trainer(config, total_dataset_size=len(train.dataset))
        seen = {}
        tr.training_loop(train, None, callbacks=[
            lambda t, m: seen.update({m["step"]: m["train_loss"]})])
        runs.append((seen, _flat(mesh.gather_params(tr.dit_params, tr.mesh)),
                     tr.optimizer.state_dict()["nu"]))
    return {"loss_a": runs[0][0], "loss_b": runs[1][0],
            "final_a": runs[0][1], "final_b": runs[1][1],
            "nu_shard": {k: v.clone() for k, v in runs[1][2].items()}}


CASES = {f.__name__: f for f in (dp_train, dp_ckpt, cursor, dp_serve,
                                 tp_serve, tp_train, tp_ckpt)}
BEFORE_GROUP = {"dp_serve": dp_serve_one, "tp_serve": tp_serve_one}


def main():
    case, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    import torch.distributed as dist

    from gtax_torch.parallel import mesh

    path = os.path.join(d, "inputs.pt")
    inp = torch.load(path, weights_only=True) if os.path.exists(path) else {}
    # a one-process reference runs before the group: inside it a 1x1 mesh
    # is refused
    extra = ((BEFORE_GROUP[case](rank, world, inp),)
             if case in BEFORE_GROUP else ())
    if "GTAX_NUM_PROCESSES" in os.environ:
        joined = mesh.initialize_distributed(device="cpu",
                                             timeout_s=TIMEOUT_S)
    else:
        joined = mesh.initialize_distributed(
            f"file://{d}/store", world, rank, device="cpu",
            timeout_s=TIMEOUT_S)
    assert joined and mesh.world_size() == world and (
        mesh.process_index() == rank) and dist.get_backend() == "gloo"
    out = CASES[case](rank, world, d, inp, *extra)
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
