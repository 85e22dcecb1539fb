"""The PyTorch port stands alone: importing any of its modules, or the chip
smoke script, loads neither JAX nor any module of the `airmodes` package."""

import ast
import importlib
import os
import subprocess
import sys

import airmodes_torch
from airmodes_torch.utils import graphs

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
                 "airmodes_torch.bench",
                 "airmodes_torch.graft_entry"):
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


def _jit_sites():
    """Every `jax.jit` site of `airmodes/`, by file (below `airmodes/`) and
    function: a function decorated with `jax.jit` or
    `functools.partial(jax.jit, ...)` names itself, a `jax.jit(...)` call
    the function it stands in (qualified names: `Class.method`,
    `outer.inner`). One entry per site."""
    def is_jit(node):
        return (isinstance(node, ast.Attribute) and node.attr == "jit"
                and isinstance(node.value, ast.Name)
                and node.value.id == "jax")

    def jit_decorator(node):
        return is_jit(node) or (
            isinstance(node, ast.Call) and node.args and is_jit(node.args[0])
            and getattr(node.func, "attr", None) == "partial")

    sites = []

    def walk(node, path, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = scope + [child.name]
                if not isinstance(child, ast.ClassDef):
                    sites.extend((path, ".".join(inner))
                                 for d in child.decorator_list
                                 if jit_decorator(d))
                walk(child, path, inner)
            else:
                if isinstance(child, ast.Call) and is_jit(child.func):
                    sites.append((path, ".".join(scope)))
                walk(child, path, scope)

    top = os.path.join(ROOT, "airmodes")
    for dirpath, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                walk(tree, os.path.relpath(path, top).replace(os.sep, "/"),
                     [])
    return sites


_S = "airmodes_torch.dist.sharded."
_PP = "airmodes_torch.resample.polyphase"
_K = "airmodes_torch.kernels.preamble"
# each reference `jax.jit` site (file below airmodes/, function) -> its
# counterparts, one per site: (port module, port function, the graphed
# function it is or calls, as "module.name")
_JIT_SITES = {
    ("dist/multihost.py", "PodPipeline.__post_init__"): [
        ("airmodes_torch.dist.multihost", "PodPipeline.__post_init__",
         _S + name) for name in ("_planar_local", "_planar_local",
                                 "_f32_local", "_f32_local")],
    ("dist/sharded.py", "make_sharded_demod"): [
        ("airmodes_torch.dist.sharded", "make_sharded_demod",
         _S + "_f32_local")],
    ("dist/sharded.py", "make_sharded_demod_ctx"): [
        ("airmodes_torch.dist.sharded", "make_sharded_demod_ctx",
         _S + "_f32_local")],
    ("dist/sharded.py", "make_sharded_demod_planar"): [
        ("airmodes_torch.dist.sharded", "make_sharded_demod_planar",
         _S + "_planar_local")],
    ("dist/sharded.py", "make_sharded_demod_planar_ctx"): [
        ("airmodes_torch.dist.sharded", "make_sharded_demod_planar_ctx",
         _S + "_planar_local")],
    ("dist/sharded.py", "make_sharded_resample_demod"): [
        ("airmodes_torch.dist.sharded", "make_sharded_resample_demod",
         _S + "_resample_local")] * 2,
    ("kernels/preamble_pallas.py", "demod_block_packed_pallas_jit"): [
        (_K, "demod_block_packed_1d_jit", _K + ".demod_block_packed_1d_jit")],
    ("kernels/preamble_pallas.py", "demod_batch_packed_pallas_jit"): [
        (_K, "demod_batch_packed_1d_jit", _K + ".demod_batch_packed_1d_jit")],
    ("kernels/preamble_pallas.py", "demod_block_packed_fast_jit"): [
        (_K, "demod_block_packed_fast_jit",
         _K + ".demod_block_packed_fast_jit")],
    ("kernels/preamble_pallas.py", "demod_batch_packed_fast_jit"): [
        (_K, "demod_batch_packed_fast_jit",
         _K + ".demod_batch_packed_fast_jit")],
    ("kernels/preamble_pallas.py", "demod_batch_packed_planar_jit"): [
        (_K, "demod_batch_packed_planar_jit",
         _K + ".demod_batch_packed_planar_jit")],
    ("resample/fused.py", "resample_demod_packed_planar_jit"): [
        ("airmodes_torch.resample.fused", "resample_demod_packed_planar_jit",
         "airmodes_torch.resample.fused.resample_demod_packed_planar_jit")],
    ("resample/polyphase.py", "_streaming_kernel"): [
        (_PP, "streaming_resampler._kernel", _PP + "._streaming_kernel")],
    ("resample/polyphase.py", "resample_planar"): [
        (_PP, "resample_planar", _PP + "._resample_planar_step")],
    ("resample/polyphase.py", "resample"): [
        (_PP, "resample", _PP + "._resample_step")],
    ("io/native_stream.py", "_planar_step.step"): [
        ("airmodes_torch.io.native_stream", "_planar_step",
         "airmodes_torch.io.native_stream._full_block_rows")],
    ("io/stream.py", "_xla_batch_step_impl.step"): [
        ("airmodes_torch.io.stream", "_batch_step",
         "airmodes_torch.dsp.pipeline.demod_batch_packed_jit")],
    ("dsp/pipeline.py", "demod_block_jit"): [
        ("airmodes_torch.dsp.pipeline", "demod_block_jit",
         "airmodes_torch.dsp.pipeline.demod_block_jit")],
    ("dsp/pipeline.py", "demod_block_packed_jit"): [
        ("airmodes_torch.dsp.pipeline", "demod_block_packed_jit",
         "airmodes_torch.dsp.pipeline.demod_block_packed_jit")],
    ("dsp/pipeline.py", "demod_batch_jit"): [
        ("airmodes_torch.dsp.pipeline", "demod_batch_jit",
         "airmodes_torch.dsp.pipeline.demod_batch_jit")],
}


def _function_node(module, qualname):
    """The ast node of `qualname` (`Class.method`, `outer.inner`) in the
    port module's source."""
    path = importlib.import_module(module).__file__
    with open(path) as f:
        node = ast.parse(f.read(), path)
    for part in qualname.split("."):
        node = next(n for n in ast.walk(node)
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and n.name == part)
    return node


def test_every_reference_jit_site_is_graphed():
    """Each of the reference's 24 `jax.jit` sites maps, by the explicit
    `_JIT_SITES` (a stale or missing entry fails), to a counterpart that
    is a `graphs.Graphed` (a captured CUDA graph per key on a card) or
    calls one: each factory's step (the sharded steps, `PodPipeline`'s),
    each wrapper (`resample`, `resample_planar`) and each caller of a
    compiled step (the streaming resampler's stride, the runners' steps)
    names its module-level graphed function."""
    sites = _jit_sites()
    assert len(sites) == 24
    assert sorted(sites) == sorted(k for k, v in _JIT_SITES.items()
                                   for _ in v)
    for site, counterparts in _JIT_SITES.items():
        for module, qualname, target in counterparts:
            tmod, _, name = target.rpartition(".")
            assert isinstance(getattr(importlib.import_module(tmod), name),
                              graphs.Graphed), (site, target)
            if (module, qualname) == (tmod, name):
                continue
            used = {getattr(n, "id", None) or n.attr
                    for n in ast.walk(_function_node(module, qualname))
                    if isinstance(n, (ast.Name, ast.Attribute))}
            assert name in used, (site, qualname, name)


def _top_level_names(path):
    """Every top-level function and class of a source file, private ones
    included."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def test_graft_entry_names_are_ported():
    """The reference's graft entry points (`__graft_entry__.py` at the
    repository's root, outside `airmodes/`) have their counterpart in
    `airmodes_torch.graft_entry`, name for name."""
    want = _top_level_names(os.path.join(ROOT, "__graft_entry__.py"))
    assert want == {"_tiny_cfg", "entry", "dryrun_multichip"}
    assert want <= _top_level_names(
        os.path.join(PKG, "graft_entry.py"))


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
