"""The serving CLI and eval_needle on a mesh of four ranks under torchrun,
against one rank's runs of the same tiny checkpoint (fp32, random weights
from a seed, the fixture BPE tokenizer): the server at 1,1,2,2 (tp 2 x sp 2,
the slots' caches split over sp) and 2,1,2,1 (dp 2 x tp 2) must write the
one-rank completions, eval_needle at !1,-1,4,1 (tp 4) its results JSON.
On four cards the ranks join over NCCL; `--cpu` runs the same on the CPU
over gloo. Exits 1 on a difference.

    python3 scripts/check_mesh_clis.py          # needs four cards
    python3 scripts/check_mesh_clis.py --cpu
"""
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CFG = ("dict(vocab_size=1024,hidden_size=256,intermediate_size=512,num_hidden_layers=2,"
       "num_attention_heads=4,max_sequence_length=4096,scan_attention=False,scan_mlp=False,"
       "scan_layers=False,scan_query_chunk_size=32,scan_key_chunk_size=32)")
TOK = ROOT / "tests" / "fixtures" / "tokenizer_bpe"
EXTRA = ["--device=cpu"] if "--cpu" in sys.argv[1:] else []


def run(cmd, what):
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    print(f"== {what}: rc {r.returncode}; {' '.join(cmd[:6])} ...", flush=True)
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-6000:], flush=True)
        sys.exit(1)
    return r


def main():
    with tempfile.TemporaryDirectory(prefix="lwm_mesh_clis_") as tmp:
        return check(Path(tmp))


def check(work):
    import numpy as np
    import torch

    from lwm_tpu_torch import checkpoint
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
    from lwm_tpu_torch.utils.convert import flax_params_tree

    cfg = LLaMAConfig.from_dict(eval(CFG, {"dict": dict}))
    model = LLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(work / "params"))
    rng = np.random.default_rng(0)
    words = "the grass is green and the sky is blue here we go there and back again".split()
    with open(work / "req.jsonl", "w") as f:
        for n in (10, 80, 30, 120, 3, 45, 60, 20):
            f.write(json.dumps({"prompt": " ".join(rng.choice(words, n)), "max_new_tokens": 24})
                    + "\n")
    with open(work / "hay.jsonl", "w") as f:
        for _ in range(20):
            f.write(json.dumps({"text": " ".join(rng.choice(words, 200)) + ". "}) + "\n")
    serve = ["-m", "lwm_tpu_torch.apps.serve", "--load_llama_config=debug",
             f"--update_llama_config={CFG}", f"--tokenizer={TOK}",
             f"--load_checkpoint=params::{work / 'params'}", f"--input_file={work / 'req.jsonl'}",
             "--dtype=fp32", "--slots=4", "--cache_len=1024", "--prompt_buckets=64,256", *EXTRA]
    trun = ["torchrun", "--standalone", "--nproc_per_node=4"]
    outs = {}
    for name, launch, mesh in (("one rank", [sys.executable], "1,1,1,1"),
                               ("4 ranks 1,1,2,2", trun, "1,1,2,2"),
                               ("4 ranks 2,1,2,1", trun, "2,1,2,1")):
        out = work / f"serve_{mesh}.jsonl"
        run(launch + serve + [f"--mesh_dim={mesh}", f"--output_file={out}"], f"serve {name}")
        outs[name] = sorted(json.loads(l)["completion"] for l in out.read_text().splitlines())
    ok = all(v == outs["one rank"] for v in outs.values())
    print(f"serve completions equal to one rank's: {ok} ({len(outs['one rank'])} requests)")
    needle = ["-m", "lwm_tpu_torch.apps.eval_needle", "--load_llama_config=debug",
              f"--update_llama_config={CFG}", f"--tokenizer={TOK}",
              f"--load_checkpoint=params::{work / 'params'}",
              f"--haystack_file={work / 'hay.jsonl'}",
              "--context_lengths_min=500", "--context_lengths_max=900",
              "--n_context_length_intervals=2", "--n_document_depth_intervals=2", "--n_rounds=2",
              *EXTRA]
    res = {}
    for name, launch, mesh in (("one rank", [sys.executable], "1,-1,1,1"),
                               ("4 ranks !1,-1,4,1", trun, "!1,-1,4,1")):
        out = work / f"needle_{len(res)}.json"
        run(launch + needle + [f"--mesh_dim={mesh}", f"--output_file={out}"], f"eval {name}")
        res[name] = json.loads(out.read_text())
    same = res["one rank"] == res["4 ranks !1,-1,4,1"]
    print(f"eval_needle results equal to one rank's: {same} ({len(res['one rank'])} rows)")
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
