"""Batch/interactive serving CLI over the port's in-flight batching server.

Counterpart of `lwm_tpu/apps/serve.py`, with the same flag names and
defaults, parsed by `argparse` (absl is not a dependency): `--name=value`,
a bare `--flag` for a true bool, and `--llama.<field>=value` for the config
fields when no `--load_llama_config` is given. Loads a streamed checkpoint
(`--load_checkpoint=params::PATH`, `lwm_tpu_torch.checkpoint`; scanned or
unscanned trees convert as they are), casts it to `--dtype`, optionally
quantizes the dense weights to int8 on the device (`--quantize_weights`,
`--quant_dense`), reads the tokenizer from a local directory
(`lwm_tpu_torch.utils.tokenizer`; a hub name is refused) and serves prompts
through `lwm_tpu_torch.serve.InflightServer`, with its serving modes:
`--prefix_file` / `--prefix_chunk` / `--prefix_cache` (a shared document
prefilled once; prompts are suffix-only), `--lookup_k` / `--lookup_ngram`
(prompt-lookup verify) and `--admit_chunk` (chunked admission).

Input modes:
- `--input_file=requests.jsonl`: one JSON object a line with `prompt` and
  optional `max_new_tokens` / `temperature`; completions go to
  `--output_file` (JSONL: id, prompt, completion, stop reason, token count)
  in completion order.
- no input_file: interactive, one prompt a stdin line, its completion
  printed.

`--device` (default `cuda`) stands in for the JAX `--jax_platform`: the
model runs on the card, or on the CPU with `--device=cpu`; without CUDA
and without `--device=cpu` it raises. `--mesh_dim` other than `1,1,1,1`
raises: the port serves on one device.

Run: python -m lwm_tpu_torch.apps.serve --load_checkpoint='params::...' \\
    --tokenizer=LOCAL_DIR --slots=8 --cache_len=4096 [--quantize_weights]
(`scripts/run_serve_torch.sh` is the bundle.)
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from lwm_tpu_torch.checkpoint import load_trainstate_checkpoint
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.ops.quant import quantize_params_int8
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.tokenizer import Tokenizer

DEFAULTS = dict(
    input_file="", output_file="completions.jsonl", slots=8, cache_len=4096,
    prompt_buckets="256,1024,2048", max_new_tokens=256, temperature=0.0,
    quantize_weights=False, quant_dense="int8", prefix_file="", prefix_chunk=2048,
    prefix_cache="", lookup_k=0, lookup_ngram=3, admit_chunk=0, mesh_dim="1,1,1,1",
    device="cuda", seed=0, dtype="bf16", load_llama_config="", update_llama_config="",
    load_checkpoint="", tokenizer="LargeWorldModel/LWM-Text-1M",
)


def _bool(text):
    low = str(text).lower()
    if low in ("1", "true", "t", "yes", "y"):
        return True
    if low in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {text!r}")


def _literal(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_flags(argv):
    """The flags as a namespace, plus `llama`: the `--llama.<field>` values."""
    parser = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.serve")
    for name, default in DEFAULTS.items():
        if isinstance(default, bool):
            parser.add_argument(f"--{name}", type=_bool, nargs="?", const=True, default=default)
            parser.add_argument(f"--no{name}", dest=name, action="store_false")
        else:
            parser.add_argument(f"--{name}", type=type(default), default=default)
    flags, rest = parser.parse_known_args(argv)
    flags.llama = {}
    for arg in rest:
        key, sep, value = arg.partition("=")
        if not (key.startswith("--llama.") and sep):
            parser.error(f"unrecognized argument: {arg}")
        flags.llama[key[len("--llama."):]] = _literal(value)
    return flags


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_model(flags):
    """(model, tokenizer) as `lwm_tpu/apps/serve.py:load_model` builds them."""
    if flags.mesh_dim.lstrip("!") not in ("1,1,1,1", ""):
        raise NotImplementedError(
            f"--mesh_dim={flags.mesh_dim}: the port serves on one device (meshes are not "
            "ported yet)"
        )
    device = torch.device(flags.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to serve on the CPU")
    enc = Tokenizer(flags.tokenizer)
    if flags.load_llama_config:
        config = LLaMAConfig.load_config(flags.load_llama_config)
    else:
        config = LLaMAConfig.from_dict(flags.llama)
    updates = {}
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=5e7, ...)"
        updates.update(eval(flags.update_llama_config, {"dict": dict}))  # noqa: S307
    updates.update(
        bos_token_id=enc.bos_token_id, eos_token_id=enc.eos_token_id, decode_index="per_row",
        max_sequence_length=max(updates.get("max_sequence_length", config.max_sequence_length),
                                flags.cache_len),
    )
    config = LLaMAConfig.from_dict({**dataclasses.asdict(config), **updates})
    dtype = get_float_dtype_by_name(flags.dtype)

    t0 = time.perf_counter()
    _, params = load_trainstate_checkpoint(flags.load_checkpoint, disallow_trainstate=True)
    sd = convert_flax_params(params, config, dtype=dtype)
    del params
    sd = {k: v.to(device) for k, v in sd.items()}
    log(f"loaded {flags.load_checkpoint} in {time.perf_counter() - t0:.1f}s")
    if flags.quantize_weights:
        log(f"quantizing dense weights to int8 ({flags.quant_dense})...")
        sd = quantize_params_int8(sd)
        config = config.replace(quant_dense=flags.quant_dense)
    return LLaMAForCausalLM.on_tensors(config, sd, dtype), enc


def main(argv=None):
    flags = parse_flags(sys.argv[1:] if argv is None else argv)
    torch.manual_seed(flags.seed)
    np.random.seed(flags.seed)
    model, enc = load_model(flags)
    buckets = tuple(int(b) for b in flags.prompt_buckets.split(","))
    stop = tuple(t for t in (enc.eos_token_id,) if t is not None)
    prefix_ids = None
    if flags.prefix_file:
        with open(flags.prefix_file, encoding="utf-8") as f:
            prefix_ids = enc.encode(f.read())
        if enc.bos_token_id is not None and (not prefix_ids or prefix_ids[0] != enc.bos_token_id):
            prefix_ids = [enc.bos_token_id] + prefix_ids
        log(f"shared prefix: {len(prefix_ids)} tokens (prefilling once)")
    srv = InflightServer(
        model, slots=flags.slots, cache_len=flags.cache_len, prompt_buckets=buckets,
        stop_tokens=stop, seed=flags.seed, prefix_ids=prefix_ids,
        prefix_chunk=flags.prefix_chunk, prefix_cache_path=flags.prefix_cache,
        lookup_k=flags.lookup_k, lookup_ngram=flags.lookup_ngram, admit_chunk=flags.admit_chunk,
    )

    def encode(text):
        ids = enc.encode(text)
        if prefix_ids is not None:   # prompts continue the shared prefix, whose bos it holds
            return [t for t in ids if t != enc.bos_token_id]
        if enc.bos_token_id is not None and (not ids or ids[0] != enc.bos_token_id):
            ids = [enc.bos_token_id] + ids
        return ids

    if not flags.input_file:
        log("interactive mode — one prompt per line (EOF to quit)")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            srv.submit(encode(line), flags.max_new_tokens, flags.temperature)
            fin = srv.run()[-1]
            print(enc.decode(fin.tokens, skip_special_tokens=True), flush=True)
        return

    prompts = {}
    with open(flags.input_file, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            req = json.loads(line)
            rid = srv.submit(encode(req["prompt"]),
                             int(req.get("max_new_tokens", flags.max_new_tokens)),
                             float(req.get("temperature", flags.temperature)))
            prompts[rid] = req["prompt"]
    log(f"{len(prompts)} requests queued over {flags.slots} slots")

    t0 = time.perf_counter()
    n_tokens = 0
    with open(flags.output_file, "w", encoding="utf-8") as out:
        while srv.busy():
            for fin in srv.step():
                n_tokens += len(fin.tokens)
                out.write(json.dumps(dict(
                    id=fin.req_id, prompt=prompts[fin.req_id],
                    completion=enc.decode(fin.tokens, skip_special_tokens=True),
                    stopped=fin.stopped, n_tokens=len(fin.tokens),
                )) + "\n")
    dt = time.perf_counter() - t0
    log(f"served {len(prompts)} requests / {n_tokens} tokens in {dt:.1f}s "
        f"({n_tokens / dt:.1f} tok/s) → {flags.output_file}")
    log(srv.stats_line())


if __name__ == "__main__":
    main()
