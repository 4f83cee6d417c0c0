"""Ranks of the port's mesh tests (training and inference on dp × fsdp × tp
× sp): each a spawned process on the CPU, joined over gloo
(`torch.distributed`), importing nothing of JAX. A test module spawns its
ranks once (`spawn`) and reads what they wrote into its work directory."""

import json
import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, workdir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, workdir, payload)
    except BaseException:
        with open(os.path.join(workdir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world, workdir, payload):
    """Run fn(rank, world, workdir, payload) on `world` gloo ranks (CPU)."""
    mp.spawn(_entry, args=(world, _free_port(), fn, str(workdir), payload), nprocs=world,
             join=True)


def regroup(rank, world, port):
    """Leave the job's process group; ranks below `world` join a new one of
    `world` ranks at `port` (a spawn's ranks reused for a smaller job).
    Returns whether this rank is in it."""
    dist.destroy_process_group()
    if rank >= world:
        return False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    return True


# ------------------------------------------------------------------ the ring


def ring_inputs(case):
    """A ring case's global inputs in slot order, numpy fp32: q, k, v, the
    cotangent, a per-key bias [b, 1, 1, S] (holes away from document
    starts, so every query sees a key) and segment ids [b, S] of three
    documents over the positions."""
    world, layout, h, h_kv, s_local, d, seed = (case[k] for k in (
        "world", "layout", "h", "h_kv", "s_local", "d", "seed"))
    b, seq = 2, world * s_local
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, seq, h, d), np.float32)
    k = rng.standard_normal((b, seq, h_kv, d), np.float32)
    v = rng.standard_normal((b, seq, h_kv, d), np.float32)
    g = rng.standard_normal((b, seq, h, d), np.float32)
    from lwm_tpu_torch.ops.striped import stripe_positions

    pos = stripe_positions(seq, world) if layout == "striped" else np.arange(seq)
    cuts = np.asarray([[seq // 3, 2 * seq // 3], [seq // 5, seq // 2]])
    segs = ((pos[None] >= cuts[:, :1]).astype(np.int32)
            + (pos[None] >= cuts[:, 1:]).astype(np.int32))
    seg_pos = segs[:, np.argsort(pos)]                   # in position order
    first = np.concatenate([np.ones((b, 1), bool), seg_pos[:, 1:] != seg_pos[:, :-1]], 1)
    holes_pos = (rng.random((b, seq)) < 0.15) & ~first
    holes = holes_pos[:, pos]
    bias = np.where(holes, -1e30, 0.1 * rng.standard_normal((b, seq))).astype(np.float32)
    return q, k, v, g, bias[:, None, None, :], segs


def ring_ranks(rank, world, workdir, cases):
    """Each case's port ring over its first `case["world"]` ranks: out, dq,
    dk, dv of this rank's slice, written to workdir."""
    from lwm_tpu_torch.ops.ring import ring_attention

    groups = {w: dist.new_group(list(range(w))) for w in sorted({c["world"] for c in cases})}
    for i, case in enumerate(cases):
        w = case["world"]
        if rank >= w:
            continue
        q, k, v, g, bias, segs = ring_inputs(case)
        s = case["s_local"]
        sl = slice(rank * s, (rank + 1) * s)
        qt, kt, vt = (torch.from_numpy(x[:, sl]).requires_grad_() for x in (q, k, v))
        out = ring_attention(qt, kt, vt, torch.from_numpy(bias), torch.from_numpy(segs),
                             group=groups[w], layout=case["layout"])
        out.backward(torch.from_numpy(g[:, sl]))
        np.savez(os.path.join(workdir, f"ring{i}_rank{rank}.npz"), out=out.detach().numpy(),
                 dq=qt.grad.numpy(), dk=kt.grad.numpy(), dv=vt.grad.numpy())


# ------------------------------------------------------------- the trainer


def whole(model, tensors):
    """{name: the whole leaf as numpy} of `tensors` ({name: this rank's part
    of parameter name's leaf}), gathered over the model's mesh."""
    from lwm_tpu_torch.parallel.fsdp import placements

    places = placements(model)
    return {n: places[n].whole(t.detach()).numpy().copy() for n, t in tensors.items()}


def load_whole(model, sd):
    """Copy this rank's parts of the whole state dict `sd` into `model`."""
    from lwm_tpu_torch.parallel.fsdp import placements

    places = placements(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(places[n].local_part(sd[n]))


def train_mesh_ranks(rank, world, workdir, payload):
    """The port's train step at each of payload["runs"] (mesh_dim, layout)
    from the saved initial state dict: loss, accuracy and gradients of the
    whole batch (reduced over the ranks and gathered whole), then the
    metrics and the whole parameters after one AdamW step; rank 0 writes
    them, every rank its whole parameters' checksum."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    init = torch.load(os.path.join(workdir, "init.pt"))
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    cfg = LLaMAConfig.from_dict(payload["config"])
    for i, (mesh_dim, layout) in enumerate(payload["runs"]):
        mesh = create_mesh(mesh_dim, "cpu", layout)
        part = train._on_device(batch, "cpu", get_ranks_and_size(mesh))
        model = LLaMAForCausalLM(cfg, device="cpu", mesh=mesh)
        state = train.create_train_state(model, payload["optimizer"])
        load_whole(model, init)
        loss, aux = train.compute_loss(model, part)
        loss.backward()
        train.reduce_gradients(model)
        grads = whole(model, {n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        metrics = train.train_step(state, part)
        params = whole(model, dict(model.named_parameters()))
        np.save(os.path.join(workdir, f"run{i}_rank{rank}_sum.npy"),
                np.asarray([float(np.abs(v).sum()) for v in params.values()]))
        if rank == 0:
            np.savez(os.path.join(workdir, f"run{i}.npz"), loss=loss.item(), acc=aux["acc"].item(),
                     **{f"grad/{n}": v for n, v in grads.items()},
                     **{f"param/{n}": v for n, v in params.items()},
                     **{f"metric/{k}": v.item() for k, v in metrics.items()})


def train_mesh_vision_ranks(rank, world, workdir, payload):
    """A VideoLLaMA's loss (the dual loss), its metrics and its gradients
    summed over the ranks, at each of payload["runs"]; rank 0 writes them."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    init = torch.load(os.path.join(workdir, "vision_init.pt"))
    batch = dict(np.load(os.path.join(workdir, "vision_batch.npz")))
    cfg = VideoLLaMAConfig.from_dict(payload["config"])
    for i, (mesh_dim, layout) in enumerate(payload["runs"]):
        mesh = create_mesh(mesh_dim, "cpu", layout)
        model = VideoLLaMAForCausalLM(cfg, device="cpu", mesh=mesh)
        train.create_train_state(model)
        load_whole(model, init)
        loss, aux = train.compute_loss(model, train._on_device(batch, "cpu",
                                                              get_ranks_and_size(mesh)))
        loss.backward()
        train.reduce_gradients(model)
        grads = whole(model, {n: p.grad for n, p in model.named_parameters()})
        if rank == 0:
            np.savez(os.path.join(workdir, f"vision{i}.npz"), loss=loss.item(),
                     **{f"metric/{k}": v.item() for k, v in aux.items()},
                     **{f"grad/{n}": g for n, g in grads.items()})


def train_mesh_all_ranks(rank, world, workdir, payload):
    """`train_mesh_ranks`, then `train_mesh_vision_ranks` on payload["vision"],
    then `train_cli_ranks` on payload["cli"] on the first 2 ranks (regrouped
    at payload["port2"])."""
    train_mesh_ranks(rank, world, workdir, payload)
    train_mesh_vision_ranks(rank, world, workdir, payload["vision"])
    if regroup(rank, 2, payload["port2"]):
        train_cli_ranks(rank, 2, workdir, payload["cli"])


def train_cli_ranks(rank, world, workdir, argv):
    """The training CLI on every rank (gloo, the CPU)."""
    from lwm_tpu_torch import train

    summary = train.main(list(argv))
    with open(os.path.join(workdir, f"cli_rank{rank}.txt"), "w") as f:
        f.write(summary["output_dir"])


# ------------------------------------------------------- inference on a mesh


def ring_inference_inputs(case):
    """A ring_attention_inference case's global inputs, numpy fp32: q
    [b, sq, h, d], the head-major cache k, v [b, h_kv, T, d] (int8 with
    scales [b, h_kv, T] when case["int8"]), the key validity [b, T] and the
    position of the first query (q_offset): query i sees the valid keys at
    positions ≤ q_offset + i. case["dead_shard"] clears the validity of one
    shard's keys."""
    sp, h, h_kv, sq, T, d, seed = (case[k] for k in ("sp", "h", "h_kv", "sq", "T", "d", "seed"))
    b = 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, h_kv, T, d), np.float32)
    v = rng.standard_normal((b, h_kv, T, d), np.float32)
    valid = rng.random((b, T)) > 0.2
    valid[:, 0] = True
    if case.get("dead_shard") is not None:
        n = T // sp
        valid[:, case["dead_shard"] * n:(case["dead_shard"] + 1) * n] = False
    q_offset = case["q_offset"]
    valid[:, q_offset + sq:] = False   # never written yet
    scales = None
    if case.get("int8"):
        ks = np.abs(k).max(-1) / 127.0
        vs = np.abs(v).max(-1) / 127.0
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
        scales = (ks.astype(np.float32), vs.astype(np.float32))
    return q, k, v, scales, valid, q_offset


def ring_inference_ranks(rank, world, workdir, cases):
    """The port's ring_attention_inference at each case: sp 2 cases on the sp
    groups of a (1, 1, 2, 2) mesh, sp 4 cases on (1, 1, 1, 4); rank r's
    output rows (its slice when the queries are split) written to workdir."""
    from lwm_tpu_torch.ops.ring import ring_attention_inference
    from lwm_tpu_torch.parallel.mesh import create_mesh

    meshes = {2: create_mesh("1,1,2,2", "cpu"), 4: create_mesh("1,1,1,4", "cpu")}
    for i, case in enumerate(cases):
        mesh = meshes[case["sp"]]
        q, k, v, scales, valid, q_offset = ring_inference_inputs(case)
        sp, r = mesh.sp, mesh.sp_rank
        T, sq = k.shape[2], q.shape[1]
        n = T // sp
        kpos = np.arange(r * n, (r + 1) * n)
        frontier = q_offset + np.arange(sq)
        if case["mask"] == "tile":
            mask = valid[:, None, r * n:(r + 1) * n] & (kpos[None, None] <= frontier[None, :, None])
        else:
            mask = valid[:, r * n:(r + 1) * n] & (kpos[None] <= frontier[-1])
        q_sharded = case.get("q_sharded", False)
        qs = q[:, r * sq // sp:(r + 1) * sq // sp] if q_sharded else q
        kw = {}
        if scales is not None:
            kw = dict(k_scale=torch.from_numpy(scales[0][:, :, r * n:(r + 1) * n].copy()),
                      v_scale=torch.from_numpy(scales[1][:, :, r * n:(r + 1) * n].copy()))
        out = ring_attention_inference(
            torch.from_numpy(qs), torch.from_numpy(k[:, :, r * n:(r + 1) * n].copy()),
            torch.from_numpy(v[:, :, r * n:(r + 1) * n].copy()), torch.from_numpy(mask),
            mesh=mesh, kv_offset=r * n, q_offset=q_offset, q_sharded=q_sharded, **kw)
        np.save(os.path.join(workdir, f"ri{i}_rank{rank}.npy"), out.numpy())


def mesh_model(payload, mesh, **changes):
    """The saved test model on `mesh`: this rank's slices of its weights."""
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
    from lwm_tpu_torch.parallel.partition import shard_state_dict

    cfg = LLaMAConfig.from_dict({**payload["config"], **changes})
    sd = torch.load(payload["weights"])
    return LLaMAForCausalLM.on_tensors(cfg, shard_state_dict(sd, mesh), torch.float32, mesh)


def drive_server(srv, script):
    """Run a script of ('submit', prompt, max_new) / ('step', n) items,
    then drain: {request id: emitted tokens}."""
    for item in script:
        if item[0] == "submit":
            srv.submit(item[1], max_new_tokens=item[2])
        else:
            for _ in range(item[1]):
                srv.step()
    return {f.req_id: f.tokens.tolist() for f in srv.run()}


def serve_mesh_ranks(rank, world, workdir, payload):
    """The port's InflightServer, generate and one cache forward on meshes of
    the world's ranks (payload: the saved model, the server runs, the cache
    forward's inputs). Every rank writes its runs' tokens (each rank must
    emit the same); rank 0 writes the cache forward's logits."""
    from lwm_tpu_torch.generation import GenerationConfig, generate
    from lwm_tpu_torch.parallel.mesh import create_mesh
    from lwm_tpu_torch.serve import InflightServer

    results = {}
    for name, run in payload["runs"].items():
        mesh = create_mesh(run["mesh"], "cpu")
        model = mesh_model(payload, mesh, **run.get("config", {}))
        if run["kind"] == "serve":
            srv = InflightServer(model, mesh=mesh, **run["server"])
            results[name] = drive_server(srv, run["script"])
        else:   # generate: the batch's rows split over dp × fsdp
            ids = torch.from_numpy(run["ids"])
            mask = torch.from_numpy(run["mask"])
            n = ids.shape[0] // mesh.batch
            rows = slice(mesh.batch_rank * n, (mesh.batch_rank + 1) * n)
            out = generate(model, ids[rows], mask[rows], GenerationConfig(
                max_new_tokens=run["new"], eos_token_id=-1, pad_token_id=0))
            results[name] = mesh.all_gather(out, "batch", 0).tolist()
    with open(os.path.join(workdir, f"serve_rank{rank}.json"), "w") as f:
        json.dump(results, f)

    fwd = payload["forward"]
    mesh = create_mesh(fwd["mesh"], "cpu")
    model = mesh_model(payload, mesh, **fwd["config"])
    ids = torch.from_numpy(fwd["ids"])
    b, s0 = ids.shape[0], fwd["prefill"]
    cache = model.init_cache(b, fwd["cache"])
    ones = torch.ones(b, fwd["cache"], dtype=torch.bool)
    outs = [model(ids[:, :s0], ones, torch.arange(s0).expand(b, s0), cache=cache)]
    for t in range(s0, ids.shape[1]):
        outs.append(model(ids[:, t:t + 1], ones, torch.full((b, 1), t), cache=cache))
    if rank == 0:
        np.save(os.path.join(workdir, "forward.npy"), torch.cat(outs, 1).numpy())


def eval_needle_ranks(rank, world, workdir, argv):
    """eval_needle's CLI on every rank (a mesh of the world's ranks); each
    rank records the files it opens for writing."""
    from lwm_tpu_torch.apps import eval_needle

    writes, opener = [], eval_needle.open_file

    def recording(path, mode="r", *args, **kw):
        if "w" in mode:
            writes.append(str(path))
        return opener(path, mode, *args, **kw)

    eval_needle.open_file = recording
    try:
        eval_needle.main(list(argv))
    finally:
        eval_needle.open_file = opener
        with open(os.path.join(workdir, f"writes_rank{rank}.json"), "w") as f:
            json.dump(writes, f)


# ------------------------------------------------ fsdp × tp training


def _model_of(kind, config, mesh):
    if kind == "vision":
        from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM

        return VideoLLaMAForCausalLM(VideoLLaMAConfig.from_dict(config), device="cpu", mesh=mesh)
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM

    return LLaMAForCausalLM(LLaMAConfig.from_dict(config), device="cpu", mesh=mesh)


def moments(state):
    """{f"{key}/{name}": this rank's part of each optimizer moment}."""
    opt = state.optimizer
    return {f"{k}/{opt.names[p]}": v for p, st in opt.state.items() for k, v in st.items()}


def train_steps_record(state, batch, steps, fused=False, between=None, before_update=None):
    """`steps` train steps on `batch` (this rank's part): per step the
    metrics, the whole gradients (before the optimizer), the whole params
    and moments after it, and this rank's element counts of each param and
    moment; `before_update(i)`, when given, runs after step i's gradients
    are recorded and before its update, `between(i)` after step i's record.
    Every rank gathers; the caller writes rank 0's."""
    from lwm_tpu_torch import train

    model, opt = state.model, state.optimizer
    out, step, at = {}, opt.step, [0]
    grads = {}

    def keep():
        grads.update(whole(model, {n: p.grad for n, p in model.named_parameters()}))
        if before_update is not None:
            before_update(at[0])
        step()

    opt.step = keep
    places = model.placements
    for i in range(steps):
        at[0] = i
        metrics = train.train_step(state, batch, fused_lm_loss=fused)
        out.update({f"s{i}/metric/{k}": v.item() for k, v in metrics.items()})
        out.update({f"s{i}/grad/{n}": g for n, g in grads.items()})
        out.update({f"s{i}/param/{n}": v for n, v in whole(
            model, dict(model.named_parameters())).items()})
        names = {f"{k}/{opt.names[p]}": opt.names[p] for p, st in opt.state.items() for k in st}
        out.update({f"s{i}/moment/{k}": places[names[k]].whole(v).float().numpy().copy()
                    for k, v in moments(state).items()})
        if between is not None:
            between(i)
    del opt.step
    out.update({f"numel/{n}": p.numel() for n, p in model.named_parameters()})
    out.update({f"numel_moment/{k}": v.numel() for k, v in moments(state).items()})
    return out


def fsdp_ranks(rank, world, workdir, payload):
    """Each of payload["runs"] (name, mesh, layout, kind, config, optimizer,
    steps): the model on the mesh sharded by `create_train_state`, the
    saved whole init cut to this rank's parts, `steps` train steps on this
    rank's part of the saved global batch (`train_steps_record`); rank 0
    writes <name>.npz, every rank its element counts to <name>_rank<r>.npz.
    Then payload["init"] (mesh, kind, config, seed): a seeded
    `init_weights` on the mesh, its whole params written by rank 0."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    for run in payload["runs"]:
        mesh = create_mesh(run["mesh"], "cpu", run["layout"])
        model = _model_of(run["kind"], run["config"], mesh)
        state = train.create_train_state(model, run["optimizer"])
        load_whole(model, torch.load(os.path.join(workdir, f"{run['kind']}_init.pt")))
        batch = dict(np.load(os.path.join(workdir, f"{run['kind']}_batch.npz")))
        got = train_steps_record(state, train._on_device(batch, "cpu", get_ranks_and_size(mesh)),
                                 run["steps"], run.get("fused", False))
        counts = {k: v for k, v in got.items() if k.startswith("numel")}
        np.savez(os.path.join(workdir, f"{run['name']}_rank{rank}.npz"), **counts)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{run['name']}.npz"), **got)
    for name, init in payload["init"].items():
        mesh = create_mesh(init["mesh"], "cpu")
        model = _model_of(init["kind"], init["config"], mesh)
        train.create_train_state(model)
        model.init_weights(torch.Generator().manual_seed(init["seed"]))
        params = whole(model, dict(model.named_parameters()))
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}.npz"), **params)


def fsdp_all_ranks(rank, world, workdir, payload):
    """`fsdp_ranks` on the spawn's 4 ranks, then `fsdp_checkpoint_ranks` on
    its first 2 (regrouped at payload["port2"])."""
    fsdp_ranks(rank, world, workdir, payload)
    if regroup(rank, 2, payload["port2"]):
        fsdp_checkpoint_ranks(rank, 2, workdir, payload["checkpoint"])


def fsdp_checkpoint_ranks(rank, world, workdir, payload):
    """World 2: the training CLI at payload["argv"] (a `1,2,1,1` run that
    saves its train state), then the one-device train state
    payload["trainstate"] loaded into a `1,1,2,1` model and trained
    payload["steps"] steps with `--fused_lm_loss` (`train_steps_record`;
    rank 0 writes loaded.npz)."""
    from lwm_tpu_torch import checkpoint, train
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    summary = train.main(list(payload["argv"]))
    with open(os.path.join(workdir, f"cli_rank{rank}.txt"), "w") as f:
        f.write(summary["output_dir"])
    mesh = create_mesh("1,1,2,1", "cpu")
    model = _model_of("text", payload["config"], mesh)
    state = train.create_train_state(model, payload["optimizer"])
    assert checkpoint.StreamingCheckpointer.load_into(payload["trainstate"], state) == "trainstate"
    batch = dict(np.load(os.path.join(workdir, "text_batch.npz")))
    got = train_steps_record(state, train._on_device(batch, "cpu", get_ranks_and_size(mesh)),
                             payload["steps"], fused=True)
    if rank == 0:
        np.savez(os.path.join(workdir, "loaded.npz"), step=state.step, **got)
