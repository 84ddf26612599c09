"""The port imports torch, and neither jax nor anything of the JAX package:
every module of whisper_tpu_torch, and every module chip_smoke.py imports,
imports in a process where `import jax` and `import whisper_tpu` fail."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = r"""
import sys
for blocked in ("jax", "jaxlib", "whisper_tpu"):
    sys.modules[blocked] = None    # any import of it now raises ImportError

def check_nothing_blocked_loaded():
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "whisper_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
"""

_PROBE_PACKAGE = _BLOCK + r"""
import importlib, pkgutil
import whisper_tpu_torch
names = ["whisper_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(whisper_tpu_torch.__path__,
                                          "whisper_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in whisper_tpu_torch.__all__:      # the lazy exports too
    getattr(whisper_tpu_torch, name)
check_nothing_blocked_loaded()
print(len(names))
"""

# chip_smoke.py imports most modules inside its functions: import the
# script as a module (without calling main), then every module named by an
# import statement anywhere in it.
_PROBE_SMOKE = _BLOCK + r"""
import ast, importlib
import chip_smoke
tree = ast.parse(open(chip_smoke.__file__).read())
names = set()
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names.add(node.module)
        for a in node.names:
            sub = f"{node.module}.{a.name}"
            try:
                importlib.import_module(sub)
            except ModuleNotFoundError as e:
                if e.name != sub:       # a blocked import inside it
                    raise               # (else a name, not a submodule)
for name in sorted(names):
    importlib.import_module(name)
check_nothing_blocked_loaded()
print(len(names))
"""


# the checkpoint loaders and the decoding strategies: importable where
# neither jax nor safetensors is installed (safetensors is imported by
# from_safetensors alone, when it is called)
_PROBE_STRATEGIES = _BLOCK + r"""
sys.modules["safetensors"] = None
from whisper_tpu_torch.weights import (
    from_hf_state_dict, from_safetensors, load_npz, param_shapes, save_npz,
    to_flat_bin)
from whisper_tpu_torch.decode import (
    beam_decode, decode_from_encoder, sample_gumbel, transcribe_tokens)
from whisper_tpu_torch.pipeline import (
    FALLBACK_TEMPERATURES, WhisperPipeline, compression_ratio)
from whisper_tpu_torch.serving_continuous import hashed_gumbel
import whisper_tpu_torch.cli
check_nothing_blocked_loaded()
print(WhisperPipeline.from_npz.__name__)
"""


def _run(probe: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", probe], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_port_imports_without_jax():
    out = _run(_PROBE_PACKAGE)
    # package, audio, cli, config, decode, decode_rules, pipeline,
    # serving_continuous, tokenizer, weights, models (+whisper), ops
    # (+_build, attention, cache_append, encoder_layer, flash_attention)
    assert int(out.split()[-1]) >= 18, out


def test_chip_smoke_imports_without_jax():
    out = _run(_PROBE_SMOKE)
    assert int(out.split()[-1]) >= 10, out


def test_loaders_and_strategies_import_without_jax_or_safetensors():
    assert _run(_PROBE_STRATEGIES).split()[-1] == "from_npz"
