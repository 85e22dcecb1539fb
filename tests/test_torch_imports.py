"""The PyTorch port stands alone: importing any of its modules, or the chip
smoke script, loads neither JAX nor any module of the `airmodes` package."""

import ast
import os
import subprocess
import sys

import airmodes_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "airmodes_torch")


def _modules():
    """Every Python module of the package (built libraries aside)."""
    names = []
    for dirpath, _, files in os.walk(PKG):
        rel = os.path.relpath(dirpath, ROOT).split(os.sep)
        if "__init__.py" not in files:
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                parts = rel if f == "__init__.py" else rel + [f[:-3]]
                names.append(".".join(parts))
    return sorted(names)


def test_every_module_is_found():
    names = _modules()
    for want in ("airmodes_torch.kernels.preamble",
                 "airmodes_torch.kernels._ext",
                 "airmodes_torch.io.native_stream",
                 "airmodes_torch.io.sources",
                 "airmodes_torch.io.stream",
                 "airmodes_torch.native",
                 "airmodes_torch.testing.encoder",
                 "airmodes_torch.dsp.pipeline",
                 "airmodes_torch.exceptions",
                 "airmodes_torch.config",
                 "airmodes_torch.crc",
                 "airmodes_torch.decode",
                 "airmodes_torch.outputs",
                 "airmodes_torch.resample.polyphase",
                 "airmodes_torch.resample.fused",
                 "airmodes_torch.io.relay",
                 "airmodes_torch.io.netclient",
                 "airmodes_torch.utils.profiling",
                 "airmodes_torch.apps.modes_rx",
                 "airmodes_torch.apps.modes_mlat",
                 "airmodes_torch.apps.modes_gui",
                 "airmodes_torch.dist.sharded",
                 "airmodes_torch.dist.multihost",
                 "airmodes_torch.testing.golden",
                 "airmodes_torch.kernels.opcount",
                 "airmodes_torch.bench"):
        assert want in names


# the reference's modules whose port has another name
_RENAMED = {"airmodes.kernels.preamble_pallas": "airmodes_torch.kernels.preamble"}


def test_every_reference_module_is_ported():
    """Each module of `airmodes/` has its counterpart in the port:
    `kernels/preamble_pallas` is `kernels/preamble` (the CUDA kernels and
    the paths around them), and `kernels/opcount` is the Hopper count of
    bytes and f32 instructions per sample (the reference's counts a
    TPU's vector passes)."""
    ref = []
    top = os.path.join(ROOT, "airmodes")
    for dirpath, _, files in os.walk(top):
        if "__init__.py" not in files:
            continue
        rel = os.path.relpath(dirpath, ROOT).split(os.sep)
        ref += [".".join(rel if f == "__init__.py" else rel + [f[:-3]])
                for f in files if f.endswith(".py")]
    names = set(_modules())
    missing = [m for m in sorted(ref)
               if _RENAMED.get(m, "airmodes_torch" + m[len("airmodes"):])
               not in names]
    assert missing == []
    assert len(ref) > 40


# reference names the port gives another name, by reference module: the
# 1-D Pallas path is the port's `_1d` path (kernel B6), the 2-D f32 path its
# `_2d` detect and `_fast` demod (B3, B4)
_RENAMED_NAMES = {
    "airmodes.kernels.preamble_pallas": {
        "preamble_detect_pallas": "preamble_detect_1d",
        "preamble_detect_pallas_batch": "preamble_detect_1d_batch",
        "preamble_detect_pallas_2d": "preamble_detect_2d",
        "preamble_detect_pallas_2d_batch": "preamble_detect_2d_batch",
        "demod_block_pallas": "demod_block_1d",
        "demod_batch_pallas": "demod_batch_1d",
        "demod_block_packed_pallas_jit": "demod_block_packed_1d_jit",
        "demod_batch_packed_pallas_jit": "demod_batch_packed_1d_jit",
        "demod_block_pallas_fast": "demod_block_fast",
        "demod_batch_pallas_fast": "demod_batch_fast",
    },
}

# reference names with no counterpart in the port, each because it
# describes the TPU
_TPU_ONLY = {
    # a jaxpr count of the TPU's (8, 128)-lane vector passes per sample;
    # the port's opcount counts the Hopper kernels' f32 instructions and
    # bytes (b1_ops_per_sample, ...) instead
    "airmodes.kernels.opcount": {"count_ops", "detect_ops_per_sample"},
    # the default `per_tile` of the TPU kernel's private in-kernel
    # extraction (`_extract_cands`); the port's ordered merge takes
    # `cand_capacity(tile)`, as the reference's public path does
    "airmodes.kernels.preamble_pallas": {"CAND_PER_TILE"},
}


def _public_names(path):
    """The public top-level functions, classes and UPPER_CASE constants
    of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)
                    and t.id.isupper()}
    return {n for n in out if not n.startswith("_")}


def test_every_reference_function_is_ported():
    """Each public top-level function, class and constant of each
    reference module has its counterpart, by name, in the port's module
    (`_RENAMED` modules, `_RENAMED_NAMES` names), except the TPU-only
    names of `_TPU_ONLY`. It pins the compiled-step family: every `*_jit`
    of the reference has its graphed counterpart."""
    top = os.path.join(ROOT, "airmodes")
    missing, jits = [], 0
    for dirpath, _, files in os.walk(top):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
            mod = ".".join(rel[:-1] if rel[-1] == "__init__" else rel)
            port = _RENAMED.get(mod, "airmodes_torch" + mod[len("airmodes"):])
            ppath = os.path.join(ROOT, *port.split("."))
            ppath = (os.path.join(ppath, "__init__.py")
                     if os.path.isdir(ppath) else ppath + ".py")
            have = _public_names(ppath)
            rename = _RENAMED_NAMES.get(mod, {})
            for name in sorted(_public_names(path)
                               - _TPU_ONLY.get(mod, set())):
                jits += name.endswith("_jit")
                if rename.get(name, name) not in have:
                    missing.append(f"{mod}.{name}")
    assert missing == []
    assert jits == 9


def test_every_renamed_or_tpu_only_name_exists_in_the_reference():
    """The two lists name real reference names (so a stale entry cannot
    hide a name the port lacks)."""
    for mod, names in list(_RENAMED_NAMES.items()) + [
            (m, {n: n for n in ns}) for m, ns in _TPU_ONLY.items()]:
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        assert set(names) <= _public_names(path), mod


def test_every_decode_and_output_module_is_ported():
    """Each module of the reference's decode/ and outputs/ has its copy in
    the port."""
    names = _modules()
    for sub in ("decode", "outputs"):
        ref = os.path.join(ROOT, "airmodes", sub)
        for f in sorted(os.listdir(ref)):
            if f.endswith(".py"):
                mod = "" if f == "__init__.py" else "." + f[:-3]
                assert f"airmodes_torch.{sub}{mod}" in names, (sub, f)


def test_package_exports_match_reference():
    """The port exports the reference package's decode and config names."""
    for name in ("parse", "AircraftReport", "cpr_decoder", "decode_alt",
                 "Config", "SourceConfig", "OutputConfig", "exceptions",
                 "run_native_channels"):
        assert name in airmodes_torch.__all__
        assert getattr(airmodes_torch, name) is not None


def test_package_exports_every_reference_export():
    """Every name of the reference package's `__all__` and of its lazily
    resolved DSP symbols (`_DSP_SYMBOLS`, read from its source: importing
    them loads JAX) is exported by the port, the compiled steps
    `demod_block_jit` and `demod_batch_jit` among them."""
    with open(os.path.join(ROOT, "airmodes", "__init__.py")) as f:
        tree = ast.parse(f.read())
    want = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in ("__all__",
                                                     "_DSP_SYMBOLS")
                for t in node.targets):
            want |= set(ast.literal_eval(node.value))
    assert {"demod_block_jit", "demod_batch_jit", "parse"} <= want
    assert want <= set(airmodes_torch.__all__)
    for name in want:
        assert getattr(airmodes_torch, name) is not None


def test_imports_load_no_jax_and_no_airmodes():
    """In a fresh interpreter: import every port module and chip_smoke, then
    check what got loaded."""
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'airmodes' "
        "or m.startswith('airmodes.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


# third-party modules the port may import only where their absence is
# handled: inside a `try` whose handler catches ImportError
_OPTIONAL = {"zmq", "PyQt5", "PySide6"}


def _optional_imports(tree):
    """Names imported inside a try/except ImportError."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        catches = {getattr(h.type, "id", None) for h in node.handlers}
        if not catches & {"ImportError", "ModuleNotFoundError"}:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Import):
                    out |= {a.name.split(".")[0] for a in sub.names}
                elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                    out.add((sub.module or "").split(".")[0])
    return out


def test_sources_name_no_jax_or_airmodes_import():
    """The port and chip_smoke import torch, numpy, the standard library
    and the port; pyzmq (the relay) and Qt (the GUI) only optionally, as
    the reference does; never JAX or `airmodes`."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                              "airmodes_torch"}
    for path in paths:
        with open(path) as f:
            optional = _optional_imports(ast.parse(f.read(), path))
        for name in _imports_of(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "airmodes"), (path, name)
            if top in _OPTIONAL:
                assert top in optional, (path, name)
            else:
                assert top in allowed, (path, name)
    assert airmodes_torch.__file__.startswith(PKG)
