"""The port imports torch and never jax: every module of
whisper_tpu_torch imports in a process where `import jax` fails."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import whisper_tpu_torch
names = ["whisper_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(whisper_tpu_torch.__path__,
                                          "whisper_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    # package, audio, cli, decode, pipeline, weights, models (+whisper),
    # ops (+_build, attention, cache_append, encoder_layer)
    assert int(r.stdout.split()[-1]) >= 13, r.stdout
