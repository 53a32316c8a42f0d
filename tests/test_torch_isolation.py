"""The port stands alone: ``lightgbm_tpu_torch`` and ``chip_smoke.py``
import torch and never jax or anything of the JAX package (lightgbm_tpu),
and chip_smoke.py refuses to run without a CUDA device."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "lightgbm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import pkgutil, sys\n"
        "import lightgbm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "print('N', sum(m.startswith('lightgbm_tpu_torch') "
        "for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 27


#: the training slice's modules, each importable without JAX (above)
TRAINING_MODULES = ("basic", "dataset", "engine", "metrics", "serialization",
                    "models/grower", "ops/histogram", "ops/histogram_flat",
                    "ops/quantize", "ops/split", "ops/wave")


def test_training_slice_modules_present():
    for mod in TRAINING_MODULES:
        assert (PORT / f"{mod}.py").is_file(), mod


def _code(text: str) -> str:
    """CUDA source without its // comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_kernel_sources_use_no_atomics():
    """The histogram and wave kernels' f32 modes reduce in a fixed order
    (chunk partials, then a combine in chunk order): no float atomics, so
    a repeated run gives the same bits.  Their int8 modes sum integers,
    exact in any order: the only atomics in those sources are the int8
    accumulation kernel's integer atomicAdds into a block's int32 cells
    in shared memory (its chunk partial then goes out with plain stores,
    summed by the int8 combine: no global atomics), and the uint16 scan's
    one unsigned counter, by which the last of a child's blocks learns it
    is last (it then reads every block's best in block order: the count
    orders nothing that is summed).  The traversal kernel's only atomic
    adds a block's int32 partial sum into a row's output, where the tree
    axis is split."""
    csrc = PORT / "ops" / "csrc"
    assert "atomic" not in _code((csrc / "histogram.cu").read_text()).lower()
    wave = re.sub(r"\s+", " ", _code((csrc / "wave.cu").read_text()))
    assert re.findall(r"atomic\w*", wave, re.IGNORECASE) == ["atomicAdd"]
    assert ("atomicAdd( reinterpret_cast<unsigned*>(pay + kPayloadScalars - "
            "1), 1u)") in wave
    common = _code((csrc / "hist_common.cuh").read_text())
    start = common.index("hist_accumulate_i8_kernel(")
    end = common.index("\n}\n", start)
    body = common[start:end]
    assert "atomic" not in (common[:start] + common[end:]).lower()
    targets = re.findall(r"atomicAdd\(([^,]+),", body)
    assert sorted(set(targets)) == ["cell + 0", "cell + 1", "cell + 2"]
    assert "int32_t s_i8[];" in body and "add(s_i8 +" in body
    assert "auto add = [&](int32_t* cell)" in body
    assert "float" not in body
    trav = _code((csrc / "traverse.cu").read_text())
    assert re.findall(r"atomic\w*\(([^,]+),", trav) == ["out + row"]
    assert "int32_t* __restrict__ out" in trav and "float" not in trav


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_chip_smoke_help_and_refusal_without_cuda(tmp_path):
    """--help works anywhere; without a card the script exits non-zero and
    prints no ok line, also from a directory holding only the script."""
    script = ROOT / "chip_smoke.py"
    helped = subprocess.run([sys.executable, str(script), "--help"],
                            env=_env(), capture_output=True, text=True,
                            timeout=120)
    assert helped.returncode == 0 and "--seed" in helped.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    for cwd, path in ((ROOT, script), (tmp_path, alone)):
        env = _env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        run = subprocess.run([sys.executable, str(path)], cwd=str(cwd),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout


def test_chip_smoke_helpers_import_without_cuda():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    import numpy as np
    X, y = cs.make_higgs_like(100, 4, 0)
    assert X.shape == (100, 4) and X.dtype == np.float32
    tree = cs.random_tree(np.random.RandomState(0), 9, np.full(4, 10),
                          {1}, 16)
    assert (tree["left_child"] < 0).sum() + (tree["right_child"] < 0).sum() \
        == 9
