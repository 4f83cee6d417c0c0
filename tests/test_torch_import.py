"""lwm_tpu_torch runs where JAX is not installed: importing every one of its
modules pulls in none of jax, flax, optax, transformers, tokenizers, msgpack,
regex, absl, ml_collections, datasets, wandb, gcsfs or tqdm, and builds no
kernel and no native code (nor needs g++)."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    # tqdm is blocked, not only looked for: `import torch` itself pulls it in
    # where it is installed (torch.hub, which falls back without it), and the
    # card's machine has none
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class NoTqdm:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "tqdm":
                    raise ImportError("no tqdm")

        sys.meta_path.insert(0, NoTqdm())
        import lwm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(lwm_tpu_torch.__path__, "lwm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for want in ("serve", "ops.flash", "ops.ring", "ops.quant", "optim", "train",
                     "utils.losses", "checkpoint", "ops.prefix", "utils.msgpack",
                     "utils.tokenizer", "apps.serve", "data", "data.text", "native",
                     "native.token_buffer", "utils.flags", "utils.io", "utils.logging",
                     "utils.rng", "models.vision_llama", "apps.serve_vision", "data.vision",
                     "generation", "apps.sampler", "apps.eval_needle", "apps.eval_needle_multi",
                     "speculative"):
            assert "lwm_tpu_torch." + want in names, names
        bad = [m for m in ("jax", "flax", "optax", "transformers", "absl", "ml_collections",
                           "msgpack", "tokenizers", "regex", "datasets", "wandb", "gcsfs",
                           "tqdm", "lwm_tpu") if m in sys.modules]
        assert not bad, bad
        from lwm_tpu_torch.ops import _build
        assert _build.load.cache_info().currsize == 0
        from lwm_tpu_torch.native import token_buffer
        assert not token_buffer._TRIED   # the packing buffer is built at first use
        print(len(names))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
