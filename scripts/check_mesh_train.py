"""The trainer on a mesh of four cards (NCCL), beside
`check_mesh_clis.py` (the serving and eval CLIs):

1. `scripts/run_train_torch.sh` at NPROC=4 MESH_DIM='!1,-1,2,2' (the
   reference bundle's mesh: tp 2 x sp 2) for STEPS steps on a tiny local
   JSONL, its losses held to one card's run of the same bundle: bf16 (the
   bundle's dtype) within BF16_RTOL, and again at --dtype=fp32 within
   F32_RTOL.
2. The 7b preset whole (32 layers) at 1,4,1,1 (fsdp 4: the weights and the
   AdamW state sharded over the four cards; ~108 GB of fp32 state, more than
   one card's 80 GB) for 2 bf16 steps of 4 x 2048 tokens: each card's peak
   memory, state bytes and step times.

    python3 scripts/check_mesh_train.py          # needs four cards
    python3 scripts/check_mesh_train.py --cpu    # 1. only, over gloo on the CPU

Exits 1 when a loss leaves one card's or a run fails.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
STEPS = 5
BF16_RTOL, F32_RTOL = 2e-2, 1e-4
CPU = "--cpu" in sys.argv[1:]
TOK = ROOT / "tests" / "fixtures" / "tokenizer"


def run(cmd, env, what):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env={**os.environ, **env})
    print(f"== {what}: rc {r.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-6000:], flush=True)
        sys.exit(1)
    return r


def bundle_losses(work, name, nproc, *extra):
    """The losses of run_train_torch.sh's STEPS steps at NPROC=nproc."""
    out = work / name
    env = dict(TOKENIZER=str(TOK), DATASET=str(work / "train.jsonl"), OUTPUT_DIR=str(out),
               NPROC=str(nproc))
    if nproc > 1:
        env["MESH_DIM"] = "!1,-1,2,2"
    flags = [f"--total_steps={STEPS}", "--save_milestone_freq=0",
             "--train_dataset.json_dataset.tokenizer_processes=2", *extra]
    if CPU:   # a smaller sequence for the CPU
        flags += ["--device=cpu", "--train_dataset.json_dataset.seq_length=256"]
    run(["bash", "scripts/run_train_torch.sh", *flags], env, f"run_train_torch.sh {name}")
    records = [json.loads(line) for line in open(out / "example-text-train" / "metrics.jsonl")]
    return [r["loss"] for r in records]


def check_bundle(work):
    import numpy as np

    rng = np.random.default_rng(0)
    words = ("the magic number needle haystack model is blue green sky grass and a of "
             "here there we go back again").split()
    with open(work / "train.jsonl", "w") as f:
        for _ in range(3000):
            f.write(json.dumps({"text": " ".join(rng.choice(words, 60))}) + "\n")
    ok = True
    for dtype, rtol in (("bf16", BF16_RTOL), ("fp32", F32_RTOL)):
        one = bundle_losses(work, f"one_{dtype}", 1, f"--dtype={dtype}")
        mesh = bundle_losses(work, f"mesh_{dtype}", 4, f"--dtype={dtype}")
        rel = [abs(a - b) / abs(b) for a, b in zip(mesh, one)]
        good = len(mesh) == len(one) == STEPS and max(rel) <= rtol
        print(f"run_train_torch.sh {dtype}: losses at !1,-1,2,2 {mesh}, one card {one}; largest "
              f"relative difference {max(rel):.3e} (tol {rtol}): {'ok' if good else 'FAILED'}",
              flush=True)
        ok &= good
    return ok


def rank_7b():
    """A torchrun rank: the 7b preset at 1,4,1,1, 2 bf16 steps (the bundle's
    AdamW: its warm-up starts at lr 0, so step 1 moves nothing)."""
    import numpy as np
    import torch

    from lwm_tpu_torch import train
    from lwm_tpu_torch.data.text import shard_batch
    from lwm_tpu_torch.models.llama import LLaMAForCausalLM
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size, initialize_distributed

    initialize_distributed(device="cuda")
    mesh = create_mesh("1,4,1,1", "cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = train.build_model_config("7b", update_llama_config=dict(max_sequence_length=2048))
    model = LLaMAForCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device=device, mesh=mesh)
    state = train.create_train_state(model, dict(adamw_optimizer=dict(
        weight_decay=0.1, lr=8e-5, end_lr=8e-5, lr_warmup_steps=5, lr_decay_steps=200)))
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (4, 2049))
    batch = dict(input_tokens=toks[:, :-1], target_tokens=toks[:, 1:],
                 loss_masks=np.ones((4, 2048), np.float32))
    part = {k: torch.from_numpy(v).to(device) for k, v in shard_batch(
        batch, get_ranks_and_size(mesh)).items()}
    times, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train.train_step(state, part)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    state_gib = sum(2 * p.numel() * 4 for p in model.parameters()) / 2**30 + sum(
        t.numel() * t.element_size() for st in state.optimizer.state.values()
        for t in st.values()) / 2**30
    print(json.dumps(dict(rank=mesh.shard_rank, losses=losses, step_s=times,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          state_gib=state_gib, params=sum(p.numel() for p in model.parameters()),
                          card=torch.cuda.get_device_name(device))), flush=True)
    torch.distributed.destroy_process_group()


def check_7b():
    r = run(["torchrun", "--standalone", "--nproc_per_node=4", "scripts/check_mesh_train.py",
             "--rank-7b"], {}, "7b at 1,4,1,1")
    rows = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    for row in sorted(rows, key=lambda x: x["rank"]):
        print(f"7b (32 layers) at 1,4,1,1, bf16, 4 x 2048: rank {row['rank']}: losses "
              f"{row['losses']}, steps {', '.join(f'{t:.3f}' for t in row['step_s'])} s, peak "
              f"{row['peak_gib']:.2f} GiB, state {row['state_gib']:.2f} GiB "
              f"({row['params'] / 1e9:.3f} B params on the card) [{smi[0] if smi else ''}]",
              flush=True)
    return len(rows) == 4 and all(math.isfinite(x) for row in rows for x in row["losses"])


def main():
    if "--rank-7b" in sys.argv[1:]:
        return rank_7b()
    with tempfile.TemporaryDirectory(prefix="lwm_mesh_train_") as tmp:
        ok = check_bundle(Path(tmp))
    if not CPU:
        ok &= check_7b()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
