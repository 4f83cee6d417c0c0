"""Video QA serving on the port: ingest the video once, answer many questions.

Counterpart of `lwm_tpu/apps/serve_vision.py`, with the same flag names and
defaults, parsed by `utils/flags.py` (`--llama.<field>=value` for the config
fields when no `--load_llama_config` is given). The video is the shared
prefix of `lwm_tpu_torch.serve.InflightServer`: its VQ codes (framed by EOF
after each frame and EOV after the last, vision-masked) are prefilled once
into a frozen KV block, and a stream of text questions is served in flight
over it through a `VideoLLaMAForCausalLM` in `sample_mode="text"`.

Prompt layout (prefix-first, so the video is shared):
  prefix : "<s>{system_prompt}" "<vision>" {codes} "</vision>", the codes
           vision-masked
  request: "USER: {question}\\n ASSISTANT:" (BOS stripped) → decode until
           EOS or the budget

Input: `--input_codes_file`, pre-tokenized VQ codes, one JSON list a frame a
line (the vision data pipeline's format); or `--input_file`, an image
(.png/.jpg/.jpeg) or a video (up to `--max_n_frames` frames sampled evenly),
center-cropped to 256 x 256 and encoded by the port's VQGAN
(`--vqgan_checkpoint`, on `--device`). Reading the file needs PIL, and a
video OpenCV too, imported only then (`utils.image`): where they are not
installed (the card's machine) it raises ImportError, so there the input is
a codes file. Questions:
`--questions_file`, JSONL ({"question": ..., optional "max_new_tokens" /
"temperature"}), answered into `--output_file` (JSONL: id, question, answer,
stop reason, token count) in completion order; or interactive, one question
a stdin line, its answer printed. `--prefix_cache` saves the built video KV
(or loads it, skipping the build); `--lookup_k`, `--admit_chunk` and
`--prefix_chunk` pass through to the server.

`--device` (default `cuda`) stands in for the JAX `--jax_platform`: without
CUDA and without `--device=cpu` it raises.

Run: python -m lwm_tpu_torch.apps.serve_vision --load_checkpoint='params::...' \\
    --tokenizer=LOCAL_DIR --input_codes_file=codes.jsonl --questions_file=qs.jsonl
(`scripts/run_serve_vision_torch.sh` is the bundle.)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from lwm_tpu_torch.checkpoint import load_trainstate_checkpoint
from lwm_tpu_torch.models.vision_llama import (
    VideoLLaMAConfig,
    VideoLLaMAForCausalLM,
    frame_tokens,
)
from lwm_tpu_torch.models.vqgan import VQGAN
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.flags import parse_flags as parse_flags_tree
from lwm_tpu_torch.utils.image import read_frames
from lwm_tpu_torch.utils.tokenizer import Tokenizer

DEFAULTS = dict(
    input_file="", input_codes_file="", vqgan_checkpoint="", questions_file="",
    output_file="answers.jsonl", system_prompt="You are a helpful assistant. ", slots=4,
    cache_len=1024, prompt_buckets="64,128,256", max_new_tokens=256, temperature=0.0,
    lookup_k=0, lookup_ngram=3, admit_chunk=0, max_n_frames=8, prefix_chunk=2048,
    prefix_cache="", device="cuda", seed=0, dtype="bf16", load_llama_config="",
    update_llama_config="", load_checkpoint="", tokenizer="LargeWorldModel/LWM-Text-1M",
)


def parse_flags(argv):
    """The flags as a namespace, plus `llama`: the `--llama.<field>` values."""
    return parse_flags_tree(DEFAULTS, argv, prog="python -m lwm_tpu_torch.apps.serve_vision",
                            free=("llama",))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def encode_file_frames(flags):
    """The codes [t, 16, 16] of `--input_file` through VQGAN
    (`lwm_tpu/apps/serve_vision.py:92-111`)."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise ImportError("--input_file needs PIL to read an image or a video's frames (and "
                          "OpenCV for a video); pass --input_codes_file instead") from e
    vqgan = VQGAN(flags.vqgan_checkpoint, replicate=False, device=flags.device)
    imgs = read_frames(flags.input_file, flags.max_n_frames)
    return vqgan.encode(imgs)[1].cpu().numpy().astype(np.int64)


def encode_video_tokens(flags):
    """The video as VQ codes, EOF after each frame and EOV after the last
    (`lwm_tpu/apps/serve_vision.py:84-116`)."""
    if flags.input_codes_file:
        frames = []
        with open(flags.input_codes_file, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    frames.append(np.asarray(json.loads(line), np.int64).reshape(-1))
    else:
        frames = list(encode_file_frames(flags))
    return frame_tokens(frames)


def load_model(flags):
    """(model, tokenizer) as `lwm_tpu/apps/serve_vision.py:load_model` builds
    them: per-row decode, `sample_mode="text"`, params cast to `--dtype`."""
    device = torch.device(flags.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to serve on the CPU")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("VideoLLaMA serving runs as one process on one device; its "
                                  "mesh comes with a later multi-GPU slice (ROADMAP A4)")
    enc = Tokenizer(flags.tokenizer)
    if flags.load_llama_config:
        config = VideoLLaMAConfig.load_config(flags.load_llama_config)
    else:
        config = VideoLLaMAConfig.from_dict(flags.llama)
    updates = {}
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=5e7, ...)"
        updates.update(eval(flags.update_llama_config, {"dict": dict}))  # noqa: S307
    updates.update(bos_token_id=enc.bos_token_id, eos_token_id=enc.eos_token_id,
                   decode_index="per_row", sample_mode="text")
    config = VideoLLaMAConfig.from_dict({**dataclasses.asdict(config), **updates})
    dtype = get_float_dtype_by_name(flags.dtype)

    t0 = time.perf_counter()
    _, params = load_trainstate_checkpoint(flags.load_checkpoint, disallow_trainstate=True)
    sd = convert_flax_params(params, config, dtype=dtype, device=device)
    del params
    log(f"loaded {flags.load_checkpoint} in {time.perf_counter() - t0:.1f}s")
    return VideoLLaMAForCausalLM.on_tensors(config, sd, dtype), enc


def video_prefix(enc, flags, vision):
    """(prefix ids, vision masks): the system prompt, <vision>, the codes
    (masked), </vision> (`lwm_tpu/apps/serve_vision.py:166-176`)."""
    head = enc.encode(f"<s>{flags.system_prompt}")
    vstart = enc.encode("<vision>", add_special_tokens=False)
    vend = enc.encode("</vision>", add_special_tokens=False)
    ids = head + vstart + vision + vend
    masks = [False] * (len(head) + len(vstart)) + [True] * len(vision) + [False] * len(vend)
    return ids, masks


def main(argv=None):
    flags = parse_flags(sys.argv[1:] if argv is None else argv)
    torch.manual_seed(flags.seed)
    np.random.seed(flags.seed)
    model, enc = load_model(flags)

    log("encoding video...")
    vision = encode_video_tokens(flags)
    prefix_ids, prefix_vm = video_prefix(enc, flags, vision)
    log(f"shared video prefix: {len(prefix_ids)} tokens ({len(vision)} vision); "
        "prefilling once...")
    buckets = tuple(int(b) for b in flags.prompt_buckets.split(","))
    stop = tuple(t for t in (enc.eos_token_id,) if t is not None)
    t0 = time.perf_counter()
    srv = InflightServer(
        model, slots=flags.slots, cache_len=flags.cache_len, prompt_buckets=buckets,
        stop_tokens=stop, seed=flags.seed, prefix_ids=prefix_ids,
        prefix_vision_masks=prefix_vm, prefix_chunk=flags.prefix_chunk,
        prefix_cache_path=flags.prefix_cache, lookup_k=flags.lookup_k,
        lookup_ngram=flags.lookup_ngram, admit_chunk=flags.admit_chunk,
    )
    log(f"video prefix ready in {time.perf_counter() - t0:.1f}s")

    def encode_q(q):
        ids = enc.encode(f"USER: {q}\n ASSISTANT:", add_special_tokens=False)
        return [t for t in ids if t != enc.bos_token_id]

    if not flags.questions_file:
        log("interactive mode — one question per line (EOF to quit)")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            srv.submit(encode_q(line), flags.max_new_tokens, flags.temperature)
            fin = srv.run()[-1]
            print(enc.decode(fin.tokens, skip_special_tokens=True), flush=True)
        return

    questions = {}
    with open(flags.questions_file, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            req = json.loads(line)
            rid = srv.submit(encode_q(req["question"]),
                             int(req.get("max_new_tokens", flags.max_new_tokens)),
                             float(req.get("temperature", flags.temperature)))
            questions[rid] = req["question"]
    log(f"{len(questions)} questions queued over {flags.slots} slots")

    t0 = time.perf_counter()
    n_tokens = 0
    with open(flags.output_file, "w", encoding="utf-8") as out:
        while srv.busy():
            for fin in srv.step():
                n_tokens += len(fin.tokens)
                out.write(json.dumps(dict(
                    id=fin.req_id, question=questions[fin.req_id],
                    answer=enc.decode(fin.tokens, skip_special_tokens=True),
                    stopped=fin.stopped, n_tokens=len(fin.tokens),
                )) + "\n")
    dt = time.perf_counter() - t0
    log(f"answered {len(questions)} questions / {n_tokens} tokens in {dt:.1f}s "
        f"({n_tokens / dt:.1f} tok/s) → {flags.output_file}")
    log(srv.stats_line())


if __name__ == "__main__":
    main()
