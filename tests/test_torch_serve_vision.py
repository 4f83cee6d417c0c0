"""Video QA serving on the port (lwm_tpu_torch.serve with a VideoLLaMA, and
the CLI `lwm_tpu_torch.apps.serve_vision`) against the JAX package on the
same converted weights (fp32, CPU): every greedy request emits exactly the
JAX server's tokens over a video prefix, for inline videos, in chunked
admission and in lookup verify; the refusals carry the JAX messages; a
video index built by either package loads in the other; and the CLI writes
the answers the JAX server and `AutoTokenizer` give as
`lwm_tpu/apps/serve_vision.py` drives them.

Where the JAX prefix builder overwrites rows (ROADMAP C2: a chunked length
past the 128-rounded store, its last chunk's write start clamped back over
earlier rows), the port's build is held to the port's own unchunked
forward instead.

Video codes are drawn below 8192 (beyond the 128-token text vocabulary),
except where a lookup proposal may quote them as text.
"""

import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer

from lwm_tpu.checkpoint import StreamingCheckpointer
from lwm_tpu.models import FlaxVideoLLaMAForCausalLM
from lwm_tpu.models import VideoLLaMAConfig as JaxConfig
from lwm_tpu.serve import InflightServer as JaxServer
from lwm_tpu_torch import serve as port_serve
from lwm_tpu_torch.apps import serve_vision as cli
from lwm_tpu_torch.models import vision_llama as port
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_sequence_length=256,
            scan_attention=False, scan_mlp=False, scan_layers=False, decode_index="per_row")
QUESTIONS = [[3, 14, 15], [27, 18, 28, 66, 9], [101, 5], [42, 42, 7, 8]]
BUDGETS = [6, 5, 7, 4]


@functools.cache
def models(sample_mode="text"):
    """(JAX model, port model) with the same weights."""
    jm = FlaxVideoLLaMAForCausalLM(
        JaxConfig(**TINY, mesh_dim=None, attn_impl="xla", sample_mode=sample_mode),
        input_shape=(1, 8), seed=0)
    cfg = port.VideoLLaMAConfig.from_dict(dict(TINY, attn_impl="auto", sample_mode=sample_mode))
    pm = port.VideoLLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm.eval()


def video(n_codes, seed, high=8192):
    """A prefix: BOS and a few text tokens, the codes (vision-masked), EOV,
    then two text tokens; (ids, masks)."""
    rng = np.random.default_rng(seed)
    head, codes = [1, 20, 21, 22], rng.integers(0, high, n_codes).tolist()
    ids = head + codes + [port.EOV, 30, 31]
    vm = [False] * len(head) + [True] * (n_codes + 1) + [False] * 2
    return ids, vm


def serve(srv, questions=QUESTIONS, budgets=BUDGETS, masks=None):
    """Submit (one step after the first, so admissions stagger), drain;
    greedy tokens by submission order."""
    masks = masks or [None] * len(questions)
    rids = []
    for i, (q, n, vm) in enumerate(zip(questions, budgets, masks)):
        rids.append(srv.submit(q, n, vision_masks=vm))
        if i == 0:
            srv.step()
    done = {f.req_id: f for f in srv.run()}
    return [done[r].tokens.tolist() for r in rids]


def both(srv_kw, **serve_kw):
    jm, pm = models()
    want = serve(JaxServer(jm, jm.params, **srv_kw), **serve_kw)
    got = serve(InflightServer(pm, **srv_kw), **serve_kw)
    return got, want


def prefix_kw(n_codes, chunk=2048):
    ids, vm = video(n_codes, n_codes)
    return dict(slots=2, cache_len=64, prompt_buckets=(8,), prefix_ids=ids,
                prefix_vision_masks=vm, prefix_chunk=chunk)


@pytest.fixture(scope="module")
def jax_prefix_runs(tmp_path_factory):
    """(n_codes, chunk) → (the JAX server's answers over that video prefix,
    the video index it saved): one JAX pool a prefix, shared by the prefix
    and index cases (a JAX pool compiles its steps anew)."""
    runs, tmp = {}, tmp_path_factory.mktemp("video_index")

    def run(n_codes, chunk=2048):
        if (n_codes, chunk) not in runs:
            jm, _ = models()
            path = tmp / f"jax_{n_codes}_{chunk}.index"
            runs[n_codes, chunk] = serve(JaxServer(jm, jm.params, prefix_cache_path=str(path),
                                                   **prefix_kw(n_codes, chunk))), path
        return runs[n_codes, chunk]

    return run


@pytest.mark.parametrize("n_codes,chunk", [(57, 2048), (293, 128)])
def test_video_prefix_matches_jax(n_codes, chunk, jax_prefix_runs):
    """The video as the shared prefix, built in one chunk, or in three
    (300 tokens, chunk 128: the chunked length 384 is the store's, so the
    JAX build is sound)."""
    _, pm = models()
    got = serve(InflightServer(pm, **prefix_kw(n_codes, chunk)))
    assert got == jax_prefix_runs(n_codes, chunk)[0]


def test_video_prefix_masks_matter():
    """The same prefix with its masks cleared is another context (the codes
    then read wte; kept below 128, EOV too, so they are text ids)."""
    _, pm = models()
    ids, vm = video(40, 3, high=128)
    ids = [t % 128 for t in ids]
    kw = dict(slots=2, cache_len=64, prompt_buckets=(8,), prefix_ids=ids)
    masked = serve(InflightServer(pm, prefix_vision_masks=vm, **kw))
    assert masked != serve(InflightServer(pm, **kw))


def rollout(pm, context, context_vm, n):
    """Greedy tokens of the port's uncached forward, re-run over the whole
    sequence a token (its RoPE table long enough for it)."""
    m = port.VideoLLaMAForCausalLM.on_tensors(pm.config.replace(max_sequence_length=512),
                                              pm.state_dict(), pm.dtype)
    seq, vm, out = list(context), list(context_vm), []
    for _ in range(n):
        with torch.no_grad():
            logits = m(torch.tensor([seq]), vision_masks=torch.tensor([vm]))
        out.append(int(logits[0, -1].argmax()))
        seq.append(out[-1])
        vm.append(False)
    return out


def test_chunked_build_past_the_store_matches_unchunked_forward():
    """ROADMAP C2: 300 prefix tokens in chunks of 256 cover 512 positions,
    past the 384-row store; the JAX builder clamps the second chunk's write
    back over rows 128-383 (the JAX CLI's own 8 frames at chunk 2048 do
    the same). The port's build cache is as long as the chunked tokens, so
    its block is the one an unchunked build writes, and each answer is the
    greedy rollout of its own uncached forward over video + question."""
    _, pm = models()
    ids, vm = video(293, 11)
    block, P_store, P_true = port_serve.build_prefix_cache(pm, ids, 256, vm)
    one, _, _ = port_serve.build_prefix_cache(pm, ids, 512, vm)
    assert (P_store, P_true) == (384, 300)
    for a, b in zip(block.layers, one.layers):
        torch.testing.assert_close(a.k, b.k, atol=1e-5, rtol=0)
        torch.testing.assert_close(a.v, b.v, atol=1e-5, rtol=0)
    got = serve(InflightServer(pm, slots=2, cache_len=64, prompt_buckets=(8,), prefix_ids=ids,
                               prefix_vision_masks=vm, prefix_chunk=256))
    assert got == [rollout(pm, ids + q, vm + [False] * len(q), n)
                   for q, n in zip(QUESTIONS, BUDGETS)]


def inline_requests(seed=9):
    """Each question behind its own 20-24-code video; (prompts, masks)."""
    rng = np.random.default_rng(seed)
    prompts, masks = [], []
    for i, q in enumerate(QUESTIONS):
        codes = rng.integers(0, 8192, 20 + i).tolist() + [port.EOV]
        prompts.append(codes + q)
        masks.append([True] * len(codes) + [False] * len(q))
    return prompts, masks


@pytest.mark.parametrize("admit_chunk", [0, 8])
def test_inline_videos_match_jax(admit_chunk):
    """Videos inline with each request (`submit(vision_masks=)`), admitted
    by bucket or staged in chunks of 8, each chunk with its slice of the
    masks."""
    prompts, masks = inline_requests()
    got, want = both(dict(slots=2, cache_len=64, prompt_buckets=(32,), admit_chunk=admit_chunk),
                     questions=prompts, masks=masks)
    assert got == want


def test_chunked_admission_over_video_prefix_matches_jax():
    """A video prefix and suffixes admitted in chunks of 4, one of them
    carrying its own codes."""
    ids, vm = video(57, 4)
    prompts, masks = inline_requests(13)
    prompts[1], masks[1] = QUESTIONS[1], None
    got, want = both(dict(slots=2, cache_len=64, prompt_buckets=(32,), prefix_ids=ids,
                          prefix_vision_masks=vm, admit_chunk=4),
                     questions=prompts, masks=masks)
    assert got == want


def test_lookup_verify_over_video_matches_jax():
    """Prompt-lookup verify (k 3) over a video prefix, with questions that
    quote the prefix's text and each other: the codes lie below 128 here,
    since a proposal may quote them back as text."""
    ids, vm = video(45, 6, high=128)
    quotes = [ids[:4] + [5, 6, 7, 5, 6], [30, 31, 9, 30, 31], ids[10:16] + ids[10:13], [8, 8, 8]]
    got, want = both(dict(slots=2, cache_len=64, prompt_buckets=(16,), prefix_ids=ids,
                          prefix_vision_masks=vm, lookup_k=3),
                     questions=quotes, budgets=[9, 8, 10, 6])
    assert got == want


def test_refusals_carry_the_jax_messages():
    jm, pm = models()
    srvs = [JaxServer(jm, jm.params, slots=2, cache_len=64, prompt_buckets=(8,)),
            InflightServer(pm, slots=2, cache_len=64, prompt_buckets=(8,))]
    msgs = []
    for srv in srvs:
        with pytest.raises(ValueError, match="vision_masks length") as e:
            srv.submit([1, 2, 3], max_new_tokens=2, vision_masks=[True])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    jm_all, pm_all = models("all")
    msgs = []
    for make in (lambda: JaxServer(jm_all, None, slots=1, cache_len=64),
                 lambda: InflightServer(pm_all, slots=1, cache_len=64)):
        with pytest.raises(ValueError, match="sample_mode") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a text pool takes no vision masks
    cfg = LLaMAConfig.from_dict(TINY)
    text = InflightServer(LLaMAForCausalLM(cfg, device="cpu"), slots=1, cache_len=64,
                          prompt_buckets=(8,))
    with pytest.raises(ValueError, match="VideoLLaMA"):
        text.submit([1, 2], 2, vision_masks=[False, True])
    with pytest.raises(ValueError, match="VideoLLaMA"):
        InflightServer(text.model, slots=1, cache_len=64, prefix_ids=[1, 2],
                       prefix_vision_masks=[False, True])


def test_video_index_loads_across_packages(jax_prefix_runs, tmp_path, monkeypatch):
    """A video index saved by the JAX server serves the port's pool, and
    one saved by the port's serves the JAX pool, with the same answers."""
    jm, pm = models()
    want, jax_index = jax_prefix_runs(57)
    kw = prefix_kw(57)
    ours = serve(InflightServer(pm, prefix_cache_path=str(tmp_path / "port.index"), **kw))
    assert ours == want

    def boom(*a, **k):
        raise AssertionError("the saved index should have been loaded")

    monkeypatch.setattr(port_serve, "build_prefix_cache", boom)
    assert serve(InflightServer(pm, prefix_cache_path=str(jax_index), **kw)) == want
    import lwm_tpu.serve as jax_serve

    monkeypatch.setattr(jax_serve, "build_prefix_cache", boom)
    assert serve(JaxServer(jm, jm.params, prefix_cache_path=str(tmp_path / "port.index"),
                           **kw)) == want


# ----------------------------------------------------------------- the CLI

TOKENIZER = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer_bpe")
CLI_MODEL = dict(vocab_size=938, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_sequence_length=128, scan_attention=False,
                 scan_mlp=False, theta=50000000)
CLI_QUESTIONS = ["what is in the video?", "how many frames", "say 12345", "who?"]


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """(params, codes file, questions file, the flags every run takes): a
    scanned VideoLLaMA params stream written by the JAX checkpointer, a
    3-frame video of 30 codes a frame, the questions."""
    tmp = tmp_path_factory.mktemp("serve_vision_cli")
    jm = FlaxVideoLLaMAForCausalLM(
        JaxConfig(**CLI_MODEL, mesh_dim=None, sample_mode="all"), input_shape=(1, 8), seed=3)
    params = tmp / "params"
    StreamingCheckpointer.save_train_state_to_file(jm.params, str(params))
    rng = np.random.default_rng(21)
    codes = tmp / "codes.jsonl"
    codes.write_text("".join(json.dumps(rng.integers(0, 8192, 30).tolist()) + "\n"
                             for _ in range(3)))
    qs = tmp / "questions.jsonl"
    qs.write_text("".join(json.dumps({"question": q}) + "\n" for q in CLI_QUESTIONS))
    flags = ["--device=cpu", "--dtype=fp32", "--slots=2", "--cache_len=64",
             "--prompt_buckets=16,32", "--max_new_tokens=6", "--load_llama_config=debug",
             f"--update_llama_config=dict({', '.join(f'{k}={v!r}' for k, v in CLI_MODEL.items())})",
             f"--load_checkpoint=params::{params}", f"--tokenizer={TOKENIZER}",
             f"--input_codes_file={codes}", "--prefix_chunk=64"]
    return params, codes, qs, flags


def jax_answers(params, codes):
    """{question: answer} from the JAX server as serve_vision.py drives it."""
    enc = AutoTokenizer.from_pretrained(TOKENIZER)
    cfg = JaxConfig.load_config("debug")
    cfg.update(dict(CLI_MODEL, bos_token_id=enc.bos_token_id, eos_token_id=enc.eos_token_id,
                    mesh_dim=None, decode_index="per_row", sample_mode="text"))
    _, tree = StreamingCheckpointer.load_trainstate_checkpoint(f"params::{params}",
                                                               disallow_trainstate=True)
    tree = tree["params"]
    from lwm_tpu.utils.checkpoint_convert import unscan_params

    tree = unscan_params(tree, cfg.num_hidden_layers, scan_axis=cfg.param_scan_axis)
    cfg.update(dict(scan_layers=False))
    model = FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 16), seed=0, dtype=jnp.float32,
                                      _do_init=False)
    frames = [json.loads(line) for line in codes.read_text().splitlines()]
    vision = []
    for t, f in enumerate(frames):
        vision += f + [8193 if t == len(frames) - 1 else 8192]
    head = enc.encode("<s>You are a helpful assistant. ")
    vstart = enc.encode("<vision>", add_special_tokens=False)
    vend = enc.encode("</vision>", add_special_tokens=False)
    prefix = head + vstart + vision + vend
    vm = [False] * (len(head) + len(vstart)) + [True] * len(vision) + [False] * len(vend)
    srv = JaxServer(model, tree, slots=2, cache_len=64, prompt_buckets=(16, 32),
                    stop_tokens=(enc.eos_token_id,), prefix_ids=prefix, prefix_vision_masks=vm,
                    prefix_chunk=64)
    rids = {}
    for q in CLI_QUESTIONS:
        ids = enc.encode(f"USER: {q}\n ASSISTANT:", add_special_tokens=False)
        rids[srv.submit([t for t in ids if t != enc.bos_token_id], 6)] = q
    return {rids[f.req_id]: enc.decode(f.tokens, skip_special_tokens=True) for f in srv.run()}


def test_cli_file_and_interactive_modes_match_jax(cli_inputs, tmp_path, monkeypatch, capsys):
    params, codes, qs, flags = cli_inputs
    want = jax_answers(params, codes)
    out = tmp_path / "answers.jsonl"
    index = tmp_path / "video.index"
    cli.main(flags + [f"--questions_file={qs}", f"--output_file={out}",
                      f"--prefix_cache={index}"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert sorted(r["id"] for r in lines) == list(range(len(CLI_QUESTIONS)))
    assert all(r["stopped"] in ("eos", "length") and r["n_tokens"] >= 1 for r in lines)
    assert {r["question"]: r["answer"] for r in lines} == want
    assert index.exists()

    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(CLI_QUESTIONS) + "\n\n"))
    monkeypatch.setattr(port_serve, "build_prefix_cache", None)   # the index loads
    cli.main(flags + [f"--prefix_cache={index}"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [want[q] for q in CLI_QUESTIONS]


def test_cli_flags_and_refusals(cli_inputs, tmp_path):
    flags = cli.parse_flags(["--slots=2", "--lookup_k=7", "--llama.hidden_size=64"])
    assert (flags.slots, flags.lookup_k, flags.llama) == (2, 7, {"hidden_size": 64})
    d = cli.parse_flags([])
    assert (d.slots, d.cache_len, d.prompt_buckets, d.max_n_frames, d.prefix_chunk,
            d.output_file, d.device) == (4, 1024, "64,128,256", 8, 2048, "answers.jsonl", "cuda")
    with pytest.raises(SystemExit):
        cli.parse_flags(["--jax_platform=cpu"])
    _, _, qs, base = cli_inputs
    no_codes = [f for f in base if not f.startswith("--input_codes_file")]
    with pytest.raises(ValueError, match="vqgan_checkpoint"):
        cli.main(no_codes + [f"--input_file={tmp_path / 'clip.mp4'}", f"--questions_file={qs}"])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        cli.main([f for f in base if f != "--device=cpu"])
