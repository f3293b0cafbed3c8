"""The port's import boundary: the package, its scripts
(``scripts/torch_*.py``) and chip_smoke.py import neither JAX nor the JAX
package, the port's applications import neither of those nor the root
``applications`` or ``bench``, and chip_smoke.py refuses to report a result
without the port or a card."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lookaheaddecoding_tpu_torch"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lookaheaddecoding_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'lookaheaddecoding_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_port_needs_no_transformers():
    """Every module of the port imports with ``transformers`` made
    unimportable (the machine with the card has none); only
    ``load_pretrained`` imports it, when called."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['transformers'] = None\n"
        "import lookaheaddecoding_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert p.ContinuousBatchingEngine and p.DecodeLog\n"
        "assert p.convert_hf_model and p.load_pretrained\n"
        "try:\n"
        "    p.load_pretrained('nowhere')\n"
        "except ImportError:\n"
        "    print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+\.*(jax|lookaheaddecoding_tpu)\b", re.M)
    sources = (sorted(PORT.rglob("*.py"))
               + sorted((ROOT / "scripts").glob("torch_*.py"))
               + [ROOT / "chip_smoke.py"])
    names = {str(p.relative_to(ROOT)) for p in sources}
    assert {"lookaheaddecoding_tpu_torch/core/paged.py",
            "lookaheaddecoding_tpu_torch/core/paged_step.py",
            "lookaheaddecoding_tpu_torch/core/paged_serving.py",
            "lookaheaddecoding_tpu_torch/core/serving.py",
            "lookaheaddecoding_tpu_torch/models/convert.py",
            "lookaheaddecoding_tpu_torch/utils/logging.py",
            "lookaheaddecoding_tpu_torch/ops/int4_micro.py",
            "lookaheaddecoding_tpu_torch/compat.py",
            "lookaheaddecoding_tpu_torch/training/train_step.py",
            "lookaheaddecoding_tpu_torch/utils/checkpoint.py",
            "lookaheaddecoding_tpu_torch/utils/profiling.py",
            "lookaheaddecoding_tpu_torch/utils/tuning.py",
            "lookaheaddecoding_tpu_torch/applications/bench_learned.py",
            "scripts/torch_int4_micro.py",
            "lookaheaddecoding_tpu_torch/parallel/sharding.py",
            "lookaheaddecoding_tpu_torch/parallel/collectives.py",
            "lookaheaddecoding_tpu_torch/parallel/launch.py",
            "scripts/torch_gloo_cuda_ops.py",
            "scripts/torch_matmul_tile_sweep.py", "chip_smoke.py"} <= names
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


APPS_PATTERN = re.compile(
    r"^\s*(import|from)\s+(applications|bench|bench_learned)\b", re.M)


def test_the_ports_applications_import_no_root_application_or_bench():
    """The port's ``applications`` subpackage neither names the root
    ``applications``, ``bench`` or ``bench_learned`` in an import, nor
    loads them, JAX or the JAX package when each of its modules is
    imported with ``transformers`` made unimportable."""
    apps = sorted((PORT / "applications").glob("*.py"))
    assert {p.name for p in apps} >= {
        "bench_learned.py", "chatbot.py", "eval_classeval.py",
        "eval_cnndm.py", "eval_common.py", "eval_humaneval.py",
        "eval_mtbench.py", "eval_xsum.py", "minimal.py", "synthetic.py",
        "train_synthetic.py"}
    for path in apps:
        hits = APPS_PATTERN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
    for text in ("import bench\n", "from applications import chatbot\n",
                 "  from applications.eval_common import run_eval\n"):
        assert APPS_PATTERN.findall(text), text
    assert not APPS_PATTERN.findall("from . import train_synthetic\n")
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['transformers'] = None\n"
        "import lookaheaddecoding_tpu_torch.applications as a\n"
        "names = [m.name for m in pkgutil.iter_modules(a.__path__)]\n"
        "for n in names:\n"
        "    importlib.import_module(a.__name__ + '.' + n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] in ('lookaheaddecoding_tpu',\n"
        "                              'applications', 'bench',\n"
        "                              'bench_learned')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok" and int(out.stdout.split()[1]) >= 11


def test_the_boundary_check_catches_a_script_that_imports_jax(tmp_path):
    """The pattern of the walk above on sources that do cross the
    boundary, and on ones that only mention the names."""
    pattern = re.compile(
        r"^\s*(import|from)\s+\.*(jax|lookaheaddecoding_tpu)\b", re.M)
    for text in ("import jax\n", "    from jax import numpy\n",
                 "from lookaheaddecoding_tpu.ops import quant\n",
                 "import lookaheaddecoding_tpu as lt\n"):
        assert pattern.findall(text), text
    for text in ("import lookaheaddecoding_tpu_torch as lt\n",
                 "# import jax\nx = 'from jax import numpy'\n",
                 "from lookaheaddecoding_tpu_torch.ops import quant\n"):
        assert not pattern.findall(text), text


def test_running_the_ports_scripts_loads_no_jax():
    """Importing each ``scripts/torch_*.py`` and chip_smoke.py (their
    ``main`` is guarded) pulls in neither JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "from pathlib import Path\n"
        "paths = sorted(Path('scripts').glob('torch_*.py'))\n"
        "paths.append(Path('chip_smoke.py'))\n"
        "for i, p in enumerate(paths):\n"
        "    spec = importlib.util.spec_from_file_location(f'_s{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'lookaheaddecoding_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len(paths))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok" and int(out.stdout.split()[1]) >= 3


def test_chip_smoke_alone_exits_nonzero_without_result(tmp_path):
    """Copied into a directory that holds nothing else of the repository
    (and, here, on a machine without a card), the script must fail and
    print no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
