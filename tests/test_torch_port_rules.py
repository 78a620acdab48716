"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro`` (checked on the AST), and
  importing the port leaves ``jax`` out of ``sys.modules``.
* Entry points default to the card: without one, ``build_model`` and
  ``ServeEngine`` raise unless ``device="cpu"`` is given.
* The CUDA wrappers refuse tensors on the CPU instead of falling back, and
  nothing builds or loads a kernel at import.
* The engine refuses, by name, every mode the port does not serve yet.
* ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and in a directory holding nothing else of the repository.
"""

import ast
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.modelspec import AttnSpec, SSMSpec
from repro_torch.kernels import (build, decode_attention, expert_gemm,
                                 flash_attention, ops,
                                 paged_decode_attention, ragged_attention,
                                 rwkv6_scan)
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, ServeEngine

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.models, repro_torch.serving\n"
            "import repro_torch.kernels.ops, repro_torch.launch.serve\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    """Make the process see no CUDA device, whatever machine runs it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_model_defaults_to_the_card(no_card):
    spec = get_reduced("minitron-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(spec, device="cuda")
    assert build_model(spec, device="cpu", dtype=torch.float32).device \
        == torch.device("cpu")


def test_engine_defaults_to_the_card(no_card):
    model = build_model(get_reduced("minitron-8b"), device="cpu",
                        dtype=torch.float32)
    cfg = EngineConfig(cache_layout="paged", unified=True, max_seq=64,
                       page_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, cfg)
    assert ServeEngine(model, cfg, device="cpu").device.type == "cpu"


def _cpu_case():
    q = torch.zeros((3, 4, 16))
    pool = torch.zeros((4, 2, 4, 16))
    pt = torch.zeros((2, 3), dtype=torch.int32)
    seg = torch.tensor([0, 1], dtype=torch.int32)
    return q, pool, pool.clone(), pt, seg, seg, seg + 1


def test_cuda_wrapper_refuses_cpu_tensors():
    """No silent fallback: the wrapper raises on CPU tensors (only
    ``ops`` routes them to the plain version) and counts no launch."""
    before = ragged_attention.launches
    with pytest.raises(ValueError, match="must lie on the card"):
        ragged_attention.ragged_paged_attention_cuda(*_cpu_case(), max_q=1)
    assert ragged_attention.launches == before
    out = ops.ragged_paged_attention(*_cpu_case(), max_q=1)
    assert out.shape == (3, 4, 16)
    assert ragged_attention.launches == before


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The paged decode, flash, expert GEMM, WKV scan and dense decode
    wrappers refuse CPU tensors too, and count no launch; ``ops`` takes the
    plain version for them."""
    q = torch.zeros((2, 1, 4, 16))
    pool = torch.zeros((4, 2, 4, 16))
    pt = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.tensor([1, 5], dtype=torch.int32)
    kv = torch.zeros((2, 8, 2, 16))
    x, w = torch.zeros((3, 5, 16)), torch.zeros((3, 16, 8))
    rkvw = torch.zeros((2, 3, 4, 16))
    u, s0 = torch.zeros((4, 16)), torch.zeros((2, 4, 16, 16))
    calls = [
        (paged_decode_attention, lambda: paged_decode_attention
         .paged_decode_attention_cuda(q, pool, pool, pt, lengths)),
        (flash_attention, lambda: flash_attention.flash_attention_cuda(
            q, kv, kv, kv_len=lengths, q_offset=lengths - 1)),
        (expert_gemm, lambda: expert_gemm.expert_gemm_cuda(x, w)),
        (rwkv6_scan, lambda: rwkv6_scan.rwkv6_scan_cuda(
            rkvw, rkvw, rkvw, rkvw, u, s0)),
        (decode_attention, lambda: decode_attention.decode_attention_cuda(
            q, kv, kv, lengths=lengths)),
    ]
    for module, call in calls:
        before = module.launches
        with pytest.raises(ValueError, match="must lie on the card"):
            call()
        assert module.launches == before
    assert ops.paged_decode_attention(q, pool, pool, pt, lengths).shape \
        == q.shape
    assert ops.multi_head_attention(q, kv, kv).shape == q.shape
    assert ops.expert_gemm(x, w).shape == (3, 5, 8)
    out, fin = ops.rwkv6_scan(rkvw, rkvw, rkvw, rkvw, u, s0)
    assert out.shape == rkvw.shape and fin.shape == s0.shape
    assert ops.decode_attention(q, kv, kv, lengths=lengths).shape == q.shape


def test_kernel_build_is_lazy_and_needs_nvcc(monkeypatch):
    """Importing the port builds and loads nothing; a build looks for nvcc
    and says where it looked when there is none."""
    assert build._LOADED == {} or torch.cuda.is_available()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    for module in (ragged_attention, paged_decode_attention,
                   flash_attention, expert_gemm, rwkv6_scan,
                   decode_attention):
        assert (REPO / module.SOURCE).is_file()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_params(source: Path, symbol: str) -> list:
    """The ctypes type of each parameter of ``extern "C" int symbol(...)``
    in a CUDA source (pointers of any type are void*)."""
    text = source.read_text()
    start = text.index(f'extern "C" int {symbol}(') + len(
        f'extern "C" int {symbol}(')
    params = text[start:text.index(")", start)].split(",")
    out = []
    for param in params:
        decl = " ".join(param.replace("const ", "").split()[:-1])
        out.append(_C_TYPES["void*" if decl.endswith("*") else decl])
    return out


@pytest.mark.parametrize("module,symbol", [
    (ragged_attention, "ragged_paged_attention_launch"),
    (paged_decode_attention, "paged_decode_attention_launch"),
    (flash_attention, "flash_attention_launch"),
    (expert_gemm, "expert_gemm_launch"),
    (rwkv6_scan, "rwkv6_scan_launch"),
    (decode_attention, "decode_attention_launch"),
], ids=lambda x: getattr(x, "__name__", str(x)).split(".")[-1])
def test_wrapper_argtypes_match_the_c_entry_point(module, symbol):
    """Each wrapper binds its C entry point with one ctypes type per C
    parameter, in order: a miscount would only show on the card."""
    assert list(module._ARGTYPES) == _c_params(REPO / module.SOURCE, symbol)


def test_cuda_headers_are_hashed_and_jax_free(tmp_path, monkeypatch):
    """Every kernel's build hash covers each csrc/*.cuh header (the
    tensor-core walk attention_tc.cuh among them), so an edited header
    rebuilds every kernel; no CUDA source names the JAX package."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "attention_tc.cuh" in headers
    for src in sorted(build.CSRC.glob("*.cu*")):
        assert "jax" not in src.read_text().lower(), src.name
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    names = [Path(m.SOURCE).stem for m in (ragged_attention,
                                            paged_decode_attention,
                                            flash_attention, expert_gemm,
                                            rwkv6_scan, decode_attention)]
    before = {n: build.digest(n) for n in names}
    tc = copy / "attention_tc.cuh"
    tc.write_text(tc.read_text() + "\n// edited\n")
    after = {n: build.digest(n) for n in names}
    assert all(before[n] != after[n] for n in names)


def test_tensor_core_ptx_helpers_live_in_one_header():
    """The ldmatrix, mma.sync and cp.async wrappers are defined once, in
    csrc/mma_ptx.cuh, and both tensor-core sources and the WKV scan's
    cp.async ring include it."""
    asm = ('"ldmatrix.sync', '"mma.sync', '"cp.async')  # inline PTX
    owners = sorted(src.name for src in build.CSRC.glob("*.cu*")
                    if any(op in src.read_text() for op in asm))
    assert owners == ["mma_ptx.cuh"]
    for name in ("attention_tc.cuh", "expert_gemm.cu", "rwkv6_scan.cu"):
        assert '#include "mma_ptx.cuh"' in (build.CSRC / name).read_text()


def _paged(**kw):
    return EngineConfig(**{"cache_layout": "paged", "unified": True,
                           "max_seq": 64, "page_size": 8, **kw})


def _refusal(case: str) -> None:
    """Construct what ``case`` names; each must raise NotImplementedError."""
    base = get_reduced("minitron-8b")
    if case == "kv-quant":
        build_model(base, device="cpu", dtype=torch.float32, kv_quant=True)
        return
    spec = get_reduced("mistral-7b-swa") if case == "swa-paged" else base
    cfg = {"swa-paged": _paged(unified=False),
           "prefix": _paged(prefix_cache=True), "spec": _paged(n_spec=2),
           "tp": _paged(tp=2), "pp": _paged(pp=2)}[case]
    ServeEngine(build_model(spec, device="cpu", dtype=torch.float32), cfg,
                device="cpu")


@pytest.mark.parametrize("case,match", [
    ("swa-paged", "ROADMAP: section 3"),
    ("kv-quant", "ROADMAP: queue 1, item 3"),
    ("prefix", "ROADMAP: queue 1, item 6"),
    ("spec", "ROADMAP: queue 1, item 7"),
    ("tp", "ROADMAP: queue 1, item 12"),
    ("pp", "ROADMAP: queue 1, item 12"),
], ids=["swa-paged", "kv-quant", "prefix", "spec", "tp", "pp"])
def test_engine_refuses_unported_modes(case, match):
    with pytest.raises(NotImplementedError, match=match):
        _refusal(case)


def test_model_and_engine_refuse_unported_architectures():
    base = get_reduced("minitron-8b")
    swa = base.scaled(attn=AttnSpec(kind="swa", window=8))
    model = build_model(swa, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        ServeEngine(model, _paged(), device="cpu")
    ssm = base.scaled(n_heads=0, n_kv_heads=0, ssm=SSMSpec())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(ssm, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        build_model(base, device="cpu", dtype=torch.float32, kv_quant=True)


def test_engine_config_keeps_the_reference_field_names():
    from repro.serving import EngineConfig as JaxEngineConfig
    ours = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(JaxEngineConfig)]
    assert ours == theirs


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
