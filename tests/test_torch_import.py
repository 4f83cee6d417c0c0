"""lwm_tpu_torch runs where JAX is not installed: importing every one of its
modules pulls in none of jax, flax, optax, transformers, tokenizers, msgpack,
regex, absl or ml_collections, and builds no kernel."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import lwm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(lwm_tpu_torch.__path__, "lwm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for want in ("serve", "ops.flash", "ops.ring", "ops.quant", "optim", "train",
                     "utils.losses", "checkpoint", "ops.prefix", "utils.msgpack",
                     "utils.tokenizer", "apps.serve"):
            assert "lwm_tpu_torch." + want in names, names
        bad = [m for m in ("jax", "flax", "optax", "transformers", "absl", "ml_collections",
                           "msgpack", "tokenizers", "regex", "lwm_tpu") if m in sys.modules]
        assert not bad, bad
        from lwm_tpu_torch.ops import _build
        assert _build.load.cache_info().currsize == 0
        print(len(names))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
