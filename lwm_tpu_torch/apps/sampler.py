"""Greedy or sampled text generation over a checkpoint, for the evals.

Counterpart of `lwm_tpu/apps/sampler.py` (`TextSampler`) with its loading
(`lwm_tpu/apps/loading.py`: `resolve_model_config` `:16`,
`load_sharded_params` `:47`): the same constructor and call,
`TextSampler(flags, greedy, stop_strings)` and `sampler(prompts,
max_input_length)`. Prompts are tokenized with their content cut from the
left to `max_input_length` and padded on the left
(`Tokenizer.batch_encode`); `lwm_tpu_torch.generation.generate` decodes
`block_size` new tokens (greedy: temperature 0, no sampling; else
temperature 1, top-k 50, top-p 1) over the shared-index cache; the text is
decoded without special tokens and cut at the eos text and at each stop
string.

`block_size` = max(scan_query_chunk_size, scan_key_chunk_size) × sp and
`data_dim` = dp × fsdp. On a mesh (`--mesh_dim` of more than one device, a
process a device under `torchrun`; `--jax_distributed.*` or torchrun's
environment join the group, as `parallel.mesh.initialize_distributed` says)
each rank loads only its tp slice of the weights (`load_model`), takes its
dp × fsdp share of the batch's rows (`sampler.py:55-65`: the batch over
(dp, fsdp), the prompt over sp) and generates them over a cache split over
sp; the ranks' tokens are gathered, so every rank returns every text.
`--unscan_for_serving` is taken: the port reads scanned and unscanned trees
alike. The model runs on `flags.device` (the card by default; "cpu" for the
CPU), its draws from a `torch.Generator` seeded with `flags.seed`.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from lwm_tpu_torch.checkpoint import load_trainstate_checkpoint
from lwm_tpu_torch.generation import GenerationConfig, generate
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.parallel.mesh import create_mesh, initialize_distributed, mesh_of
from lwm_tpu_torch.parallel.partition import check_tp
from lwm_tpu_torch.train import log
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.tokenizer import Tokenizer

# the config fields a preset takes from `--llama.*` (`loading.py:20-31`)
SCAN_FIELDS = ("scan_attention", "scan_mlp", "scan_query_chunk_size", "scan_key_chunk_size",
               "scan_mlp_chunk_size", "scan_layers", "param_scan_axis")


def resolve_model_config(flags, tokenizer=None, config_cls=LLaMAConfig):
    """`lwm_tpu/apps/loading.py:resolve_model_config`: the preset with the
    `--llama.*` scan fields over it (or the `--llama.*` config alone), then
    `--update_llama_config`, then the tokenizer's bos and eos ids; a
    `config_cls` config (`VideoLLaMAConfig` for the vision apps)."""
    llama = {k: v for k, v in flags.llama.items() if v is not None}
    if flags.load_llama_config:
        config = config_cls.load_config(flags.load_llama_config)
        updates = config_cls.from_dict(llama)
        config = config.replace(**{k: getattr(updates, k) for k in SCAN_FIELDS})
    else:
        config = config_cls.from_dict(llama)
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=1e7, ...)"
        updates = eval(flags.update_llama_config, {"dict": dict})  # noqa: S307
        config = config_cls.from_dict({**dataclasses.asdict(config), **updates})
    if tokenizer is not None:
        config = config.replace(bos_token_id=tokenizer.bos_token_id,
                                eos_token_id=tokenizer.eos_token_id)
    return config


def load_model(config, load_checkpoint, dtype, device, unscan_for_serving=False,
               model_cls=LLaMAForCausalLM, mesh=None):
    """The checkpoint's params cast to `dtype` on `device`, as a `model_cls`
    of `config` (`loading.py:load_sharded_params`); on `mesh`, this rank's
    slices only reach the device. Returns (model, config)."""
    t0 = time.perf_counter()
    if mesh is not None:
        check_tp(config, mesh.tp)
    _, params = load_trainstate_checkpoint(load_checkpoint, disallow_trainstate=True)
    if unscan_for_serving:
        config = config.replace(scan_layers=False)   # the reader takes either layout
    dtype = get_float_dtype_by_name(dtype)
    sd = convert_flax_params(params, config, dtype=dtype, device=device, mesh=mesh)
    del params
    log(f"loaded {load_checkpoint} in {time.perf_counter() - t0:.1f}s")
    kw = {} if mesh is None else dict(mesh=mesh)
    return model_cls.on_tensors(config, sd, dtype, **kw), config


class TextSampler:
    """`lwm_tpu/apps/sampler.py:TextSampler` on the port (see the module
    note). `from_model` wraps a model and tokenizer already built."""

    def __init__(self, flags, greedy=True, stop_strings=()):
        device = torch.device(getattr(flags, "device", "cuda"))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device=cpu to run on the CPU")
        initialize_distributed(getattr(flags, "jax_distributed", None), device)
        mesh = create_mesh(flags.mesh_dim, device.type)
        tokenizer = Tokenizer(flags.tokenizer)
        config = resolve_model_config(flags, tokenizer)
        model, config = load_model(config, flags.load_checkpoint, flags.dtype, device,
                                   getattr(flags, "unscan_for_serving", False),
                                   mesh=mesh if mesh.size > 1 else None)
        self._setup(model, tokenizer, greedy, stop_strings, flags.seed)
        self.flags = flags

    @classmethod
    def from_model(cls, model, tokenizer, greedy=True, stop_strings=(), seed=0):
        self = cls.__new__(cls)
        self._setup(model, tokenizer, greedy, stop_strings, seed)
        self.flags = None
        return self

    def _setup(self, model, tokenizer, greedy, stop_strings, seed):
        self.model, self.tokenizer, self.config = model, tokenizer, model.config
        self.greedy = greedy
        # decoded text is cut at the first stop string (`sampler.py:23-30`)
        self.stop_strings = tuple(stop_strings)
        self.device = model.wte.weight.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def mesh(self):
        """The model's mesh when it has more than one rank, else None."""
        return mesh_of(self.model)

    @property
    def is_rank0(self):
        return self.mesh is None or self.mesh.is_rank0

    @property
    def block_size(self):
        sp = 1 if self.mesh is None else self.mesh.sp
        return max(self.config.scan_query_chunk_size, self.config.scan_key_chunk_size) * sp

    @property
    def data_dim(self):
        return 1 if self.mesh is None else self.mesh.batch

    def generation_config(self):
        """`sampler.py:74-83`."""
        return GenerationConfig(
            max_new_tokens=self.block_size, pad_token_id=self.tokenizer.pad_token_id,
            eos_token_id=self.tokenizer.eos_token_id,
            temperature=0.0 if self.greedy else 1.0, do_sample=not self.greedy, num_beams=1,
            top_k=50, top_p=1.0)

    def encode(self, prompts, max_input_length):
        """(input_ids, attention_mask) [len(prompts), max_input_length] on the
        model's device: left-truncated, left-padded."""
        ids, mask = self.tokenizer.batch_encode(prompts, max_input_length)
        return (torch.tensor(ids, dtype=torch.long, device=self.device),
                torch.tensor(mask, dtype=torch.long, device=self.device))

    def __call__(self, prompts, max_input_length):
        input_ids, attention_mask = self.encode(prompts, max_input_length)
        mesh = self.mesh
        if mesh is not None:   # this rank's rows; the batch shards' tokens gathered
            if len(prompts) % mesh.batch:
                raise ValueError(f"{len(prompts)} prompts do not split over dp*fsdp="
                                 f"{mesh.batch}")
            n = len(prompts) // mesh.batch
            rows = slice(mesh.batch_rank * n, (mesh.batch_rank + 1) * n)
            input_ids, attention_mask = input_ids[rows], attention_mask[rows]
        output = generate(self.model, input_ids, attention_mask, self.generation_config(),
                          self.generator)
        if mesh is not None:
            output = mesh.all_gather(output, "batch", 0)
        texts = []
        eos = self.tokenizer.eos_token
        for text in self.tokenizer.batch_decode(output.tolist(), skip_special_tokens=True):
            if eos and eos in text:
                text = text.split(eos, maxsplit=1)[0]
            for stop in self.stop_strings:
                if stop in text:
                    text = text.split(stop, maxsplit=1)[0]
            texts.append(text)
        return texts
