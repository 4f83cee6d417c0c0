"""Text data pipeline of the trainer (`lwm_tpu/data/text.py:36-153, 263-477`),
in numpy: JSONL lines → the field DSL → a packed (batch, seq) batch with
next-token targets.

- `TextProcessor` (the field DSL): comma-separated fields; `[field]` gives
  loss mask 0; `a+b` joins fields by `subfield_separator`; `<|bos|>` and
  `<|eos|>` insert those tokens; `fields_from_example` reads the field list
  from the example; `prepend_text` prefixes the first field.
- `pack_batch` (and the native buffer, `lwm_tpu_torch.native`) cut the
  token stream into input / target / loss-mask rows.
- `JsonDataset`: lines sharded by `index % dp_node_size == dp_node_rank`,
  resumable by byte seek (`get_state_dict` / `load_state_dict`: example
  index, file offset and token count; the partial token buffer is dropped
  on resume, as in the reference, so only `pad` batches resume exactly),
  `pad` (one example a row), tokenization
  in a double-buffered pool of `tokenizer_processes` workers, and the
  `dataset_*` metrics. `dataset_average_tps` is the batch's tokens over the
  mean wall time between batches, so inside a training loop it reads the
  loop's rate, not the tokenizer's.

Batches stay numpy; the trainer moves them to the model's device. The
port runs on one device, so the host batch is the global batch:
`shard_batch_to_global` (the SP slice and the global jax.Array) waits for
the multi-GPU module. Configs are nested dicts (`get_default_config`); a
dataset state written by the JAX trainer, whose config is a pickled
`ConfigDict`, loads through `lwm_tpu_torch.utils.io.load_pickle`.

The tokenizer pool is made from a `spawn` context: its workers start from
a fresh interpreter (never a fork of a process that holds CUDA and
threads), each gets the text processor once (the tokenizer pickles as its
directory) and runs no torch code.
"""

from __future__ import annotations

import json
import multiprocessing
import time

import numpy as np

from lwm_tpu_torch.utils.flags import merge_config
from lwm_tpu_torch.utils.io import open_file

TEXT_PROCESSOR_DEFAULTS = dict(
    fields_from_example="", fields="", subfield_separator=" ", add_bos_token=True,
    add_eos_token=True, prepend_text="",
)
JSON_DATASET_DEFAULTS = dict(
    path="", seq_length=1024, batch_size=8, always_start_with_bos=False, start_seek_loc=0,
    example_index_at_start=0, tokens_count_at_start=0, tokenizer_processes=1,
    tokenizer_parallel_chunk_size=32, tokenizer_parallel_batch_size=1024,
    throughput_average_window_size=200, pad=False, use_data_sharded_loader=True,
    return_local_batch=False, use_native_buffer=True, sp_layout="contiguous",
)
# the dataset types the port does not load keep their JAX defaults, so the
# JAX trainer's flag tree parses unchanged
DATASET_DEFAULTS = dict(
    type="huggingface",
    text_processor=TEXT_PROCESSOR_DEFAULTS,
    huggingface_dataset=dict(path="c4", name="en", split="train", streaming=False,
                             seq_length=1024, batch_size=8, always_start_with_bos=False),
    json_dataset=JSON_DATASET_DEFAULTS,
    vision_text_processor=dict(
        fields_from_example="", fields_index=-1, subfield_separator=" ", add_bos_token=True,
        add_eos_token=True, prepend_text="", max_n_frames=-1, n_tokens_per_frame=256,
        eof_token=8192, eov_token=8193,
    ),
    json_vision_dataset=dict(
        path="", seq_length=384, batch_size=4, always_start_with_bos=False, start_seek_loc=0,
        example_index_at_start=0, tokens_count_at_start=0, tokenizer_processes=1,
        tokenizer_parallel_chunk_size=32, tokenizer_parallel_batch_size=1024,
        throughput_average_window_size=200, use_data_sharded_loader=True,
        return_local_batch=False, mode="pad", sp_layout="contiguous",
    ),
)


class DatasetFactory:
    """The dataset types by `config["type"]`: "json" loads; "huggingface"
    and "json_vision" raise NotImplementedError."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(DATASET_DEFAULTS, updates, "dataset")

    @classmethod
    def load_dataset(cls, config, tokenizer, **kwargs):
        config = cls.get_default_config(config)
        if config["type"] == "json":
            processor = TextProcessor(config["text_processor"], tokenizer)
            return JsonDataset(config["json_dataset"], tokenizer, processor, **kwargs)
        if config["type"] == "huggingface":
            raise NotImplementedError(
                "dataset type 'huggingface' is not ported: it needs the `datasets` package "
                "and a download (ROADMAP A3); use type 'json'")
        if config["type"] == "json_vision":
            raise NotImplementedError(
                "dataset type 'json_vision' is not ported yet: it comes with the vision "
                "model (ROADMAP A5)")
        raise ValueError(f"unknown dataset type: {config['type']}")


class TextProcessor:
    """The field DSL: example → (tokens, loss_masks[, aux...])."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(TEXT_PROCESSOR_DEFAULTS, updates, "text_processor")

    def __init__(self, config, tokenizer):
        self.config = self.get_default_config(config)
        if not (self.config["fields"] or self.config["fields_from_example"]):
            raise ValueError("either fields or fields_from_example must be specified")
        self.tokenizer = tokenizer

    def __call__(self, example, has_aux=False, add_bos_token=True, add_eos_token=True):
        c = self.config
        if has_aux:
            example, *aux = example
        else:
            aux = ()
        tokens, masks = [], []
        if add_bos_token and c["add_bos_token"]:
            tokens.append(self.tokenizer.bos_token_id)
            masks.append(0.0)
        if c["fields_from_example"]:
            fields = example[c["fields_from_example"]].split(",")
        else:
            fields = c["fields"].split(",")
        for i, field in enumerate(fields):
            if field.startswith("[") and field.endswith("]"):
                field, mask = field[1:-1], 0.0
            else:
                mask = 1.0
            if field == "<|bos|>":
                tokens.append(self.tokenizer.bos_token_id)
                masks.append(mask)
            elif field == "<|eos|>":
                tokens.append(self.tokenizer.eos_token_id)
                masks.append(mask)
            else:
                text = c["subfield_separator"].join(example[sub] for sub in field.split("+"))
                if i == 0:
                    text = c["prepend_text"] + text
                ids = self.tokenizer.encode(text, add_special_tokens=False)
                tokens.extend(ids)
                masks.extend([mask] * len(ids))
        if add_eos_token and c["add_eos_token"]:
            tokens.append(self.tokenizer.eos_token_id)
            masks.append(1.0)
        return (tokens, masks, *aux)


def pack_batch(token_buffer, loss_mask_buffer, batch_size, seq_length, bos_id=None,
               always_start_with_bos=False):
    """One (batch, seq) batch off the front of a flat token stream."""
    chunk = batch_size * seq_length
    batch = {
        "input_tokens": np.asarray(token_buffer[:chunk], np.int32).reshape(batch_size, -1),
        "target_tokens": np.asarray(token_buffer[1:chunk + 1], np.int32).reshape(batch_size, -1),
        "loss_masks": np.asarray(loss_mask_buffer[1:chunk + 1], np.float32).reshape(
            batch_size, -1),
    }
    if always_start_with_bos:
        batch["input_tokens"][:, 0] = bos_id
    return batch


_WORKER_PROCESSOR = None   # a pool worker's text processor (set by _init_worker)


def _init_worker(processor):
    global _WORKER_PROCESSOR
    _WORKER_PROCESSOR = processor


def _process_in_worker(example):
    return _WORKER_PROCESSOR(example, has_aux=True)


def _batched(iterator, batch_size):
    batch = []
    for example in iterator:
        batch.append(example)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


class JsonDataset:
    """JSONL lines packed into training batches; see the module note.
    `node_info`: {"dp_node_size", "dp_node_rank"} of this host."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(JSON_DATASET_DEFAULTS, updates, "json_dataset")

    def __init__(self, config, tokenizer, text_processor, node_info):
        self.config = self.get_default_config(config)
        if not self.config["path"]:
            raise ValueError("json_dataset.path is empty")
        self._tokenizer = tokenizer
        self._text_processor = text_processor
        self._node_info = node_info
        self._index = self.config["example_index_at_start"]
        self._file_loc = self.config["start_seek_loc"]
        self._total_tokens = self.config["tokens_count_at_start"]

    @staticmethod
    def _parse_line(line):
        if not line or line == "\n":
            return None
        try:
            return json.loads(line)
        except json.decoder.JSONDecodeError:
            print(f"error parsing json line:\n{line}")
            return None

    def _dp(self):
        if self.config["use_data_sharded_loader"]:
            return self._node_info["dp_node_size"], self._node_info["dp_node_rank"]
        return 1, 0

    def json_iterator(self):
        """(example, file offset after its line, line index) of this host's
        lines, from the current position, wrapping at the end of the file."""
        index, file_loc = self._index, self._file_loc
        dp_size, dp_rank = self._dp()
        with open_file(self.config["path"], "r") as fin:
            fin.seek(file_loc)
            while True:
                line = fin.readline()
                file_loc = fin.tell()
                if not line:
                    index = 0
                    fin.seek(0)
                    continue
                data = self._parse_line(line)
                if data is not None and index % dp_size == dp_rank:
                    yield data, file_loc, index
                index += 1

    def parallel_example_iterator(self):
        """(tokens, loss_masks, file_loc, index) of each example; with
        tokenizer_processes > 1 the next batch of lines tokenizes in the
        pool while the current one is consumed."""
        c = self.config
        if c["tokenizer_processes"] == 1:
            for example, loc, index in self.json_iterator():
                yield self._text_processor((example, loc, index), has_aux=True)
            return
        batches = _batched(self.json_iterator(), c["tokenizer_parallel_batch_size"])
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(c["tokenizer_processes"], initializer=_init_worker,
                      initargs=(self._text_processor,)) as pool:
            chunk = c["tokenizer_parallel_chunk_size"]
            next_batch = pool.map_async(_process_in_worker, next(batches), chunksize=chunk)
            while True:
                current = next_batch
                next_batch = pool.map_async(_process_in_worker, next(batches), chunksize=chunk)
                yield from current.get()

    def __iter__(self):
        c = self.config
        seq = c["seq_length"]
        global_chunk_size = c["batch_size"] * seq
        dp_size, _ = self._dp()
        local_batch_size = c["batch_size"] // dp_size
        chunk_size = local_batch_size * seq
        bos = self._tokenizer.bos_token_id

        native = None
        if c["use_native_buffer"] and not c["pad"]:
            from lwm_tpu_torch.native.token_buffer import NativeTokenBuffer, native_available

            if native_available():
                native = NativeTokenBuffer()
        token_buffer, loss_mask_buffer = [], []
        last_time = start_time = time.time()
        step_times = []
        start_tokens = self._total_tokens

        for tokens, loss_masks, loc, index in self.parallel_example_iterator():
            self._file_loc = loc
            self._index = index + 1   # the line at _file_loc (see get_state_dict)
            if c["pad"]:   # one example a row, cut or padded to seq + 1
                tokens = list(tokens[:seq + 1])
                tokens.extend([bos] * (seq + 1 - len(tokens)))
                loss_masks = list(loss_masks[:seq + 1])
                loss_masks.extend([0.0] * (seq + 1 - len(loss_masks)))
            if native is not None:
                native.append(tokens, loss_masks)
            else:
                token_buffer.extend(tokens)
                loss_mask_buffer.extend(loss_masks)

            while (len(native) if native is not None else len(token_buffer)) > chunk_size + 1:
                self._total_tokens += global_chunk_size
                step_times.append(time.time() - last_time)
                last_time = time.time()
                step_times = step_times[-c["throughput_average_window_size"]:]
                metrics = {
                    "dataset_file_loc": loc,
                    "dataset_example_index": index,
                    "dataset_total_tokens": self._total_tokens,
                    "dataset_accumulated_tps": (self._total_tokens - start_tokens)
                    / max(time.time() - start_time, 1e-8),
                    "dataset_average_tps": global_chunk_size / max(np.mean(step_times), 1e-8),
                }
                if native is not None:
                    batch = native.emit(local_batch_size, seq)
                    if c["always_start_with_bos"]:
                        batch["input_tokens"][:, 0] = bos
                else:
                    batch = pack_batch(token_buffer, loss_mask_buffer, local_batch_size, seq,
                                       bos_id=bos,
                                       always_start_with_bos=c["always_start_with_bos"])
                batch["input_vision_masks"] = np.zeros(batch["input_tokens"].shape, bool)
                batch["target_vision_masks"] = np.zeros(batch["input_tokens"].shape, bool)
                yield batch, metrics
                if native is None:
                    if c["pad"]:
                        token_buffer, loss_mask_buffer = [], []
                    else:
                        token_buffer = token_buffer[chunk_size:]
                        loss_mask_buffer = loss_mask_buffer[chunk_size:]

    def get_state_dict(self):
        """The resume point: `file_loc`, the offset after the last line read,
        `index`, the index of the line there, and `total_tokens`. The JAX
        dataset saves the index of the last line read instead, and labels
        the next line with it on resume, one below its index in an
        uninterrupted run (ROADMAP C4); a JAX dataset resumes from this
        state with the right indices, and the port from a JAX state as the
        JAX dataset does."""
        return dict(config=dict(self.config), index=self._index, file_loc=self._file_loc,
                    total_tokens=self._total_tokens)

    def load_state_dict(self, state_dict):
        if "config" in state_dict:
            self.config.update(state_dict["config"])
        self._index = state_dict.get("index", self.config["example_index_at_start"])
        self._file_loc = state_dict.get("file_loc", self.config["start_seek_loc"])
        self._total_tokens = state_dict.get("total_tokens", self.config["tokens_count_at_start"])

    @property
    def seq_length(self):
        return self.config["seq_length"]

    @property
    def tokenizer(self):
        return self._tokenizer

    @property
    def text_processor(self):
        return self._text_processor

    @property
    def vocab_size(self):
        return len(self._tokenizer)
