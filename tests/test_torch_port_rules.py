"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro`` (checked on the AST), and
  importing the port leaves ``jax`` out of ``sys.modules``.
* Entry points default to the card: without one, ``build_model``,
  ``ServeEngine``, ``DisaggCluster`` and the launchers raise unless
  ``device="cpu"`` is given.
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
                                 flash_attention, flash_attention_bwd, ops,
                                 paged_decode_attention, ragged_attention,
                                 ref, rwkv6_scan, rwkv6_scan_bwd)
from repro_torch.models import build_model
from repro_torch.launch import serve_chat
from repro_torch.serving import (DisaggCluster, DisaggClusterConfig,
                                 EngineConfig, ServeEngine)

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
            "import repro_torch.launch.serve_chat\n"
            "import repro_torch.core, repro_torch.scenario\n"
            "import repro_torch.scenario.engine_backend\n"
            "import repro_torch.launch.quickstart\n"
            "import repro_torch.launch.platform_dse\n"
            "import repro_torch.training.train_loop\n"
            "import repro_torch.launch.train, repro_torch.launch.train_faulty\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_model_loads_no_analytical_module():
    """``repro_torch.core`` loads its analytical modules on first use: the
    model and the engine, which read only ``modelspec``, load none."""
    code = ("import sys\n"
            "import repro_torch.models, repro_torch.serving\n"
            "import repro_torch.core\n"
            "loaded = {m.rsplit('.', 1)[1] for m in sys.modules\n"
            "          if m.startswith('repro_torch.core.')}\n"
            "assert loaded == {'modelspec', 'hardware'}, loaded\n"
            "assert repro_torch.core.Workload.__name__ == 'Workload'\n"
            "assert 'repro_torch.core.stages' in sys.modules\n")
    env = {"PYTHONPATH": f"{REPO / 'src'}", "PATH": "/usr/bin:/bin"}
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


def test_cluster_and_chat_launcher_default_to_the_card(no_card):
    model = build_model(get_reduced("minitron-8b"), device="cpu",
                        dtype=torch.float32)
    cfg = DisaggClusterConfig(max_seq=64, page_size=8, chunk_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DisaggCluster(model, cfg)
    assert DisaggCluster(model, cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_chat.main(["--requests", "1"])


def test_training_launchers_default_to_the_card(no_card):
    from repro_torch.launch import train, train_faulty
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_faulty.main(["--steps", "1"])


def test_kernels_without_a_backward_refuse_grads(monkeypatch):
    """No kernel that training reaches lacks a backward any more: on the
    card's route a grad-requiring expert GEMM or WKV scan runs through its
    autograd function, forward and backward both on the CUDA wrappers
    (stand-ins here that record their calls), never on the plain version;
    without a gradient, or under no_grad, only the forward runs."""
    calls = []

    def stand_in(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    def fwd_bounds(r, k, v, w, u, state, state_out=None, *,
                   return_bounds=False):
        out = ref.rwkv6_fwd_reference(r, k, v, w, u, state,
                                      chunk=rwkv6_scan.bound_chunk(
                                          r.shape[1]))
        return out if return_bounds else out[:2]

    def gemm_bwd(x, w, dy, need_x=True, need_w=True):
        dx, dw = ref.expert_gemm_bwd_reference(x, w, dy)
        return (dx if need_x else None), (dw if need_w else None)

    monkeypatch.setattr(ops, "_plain", lambda impl, x, what: impl == "plain")
    monkeypatch.setattr(ops, "expert_gemm_cuda", stand_in(
        "gemm", lambda x, w: ref.moe_gemm_reference(x, w)))
    monkeypatch.setattr(ops, "expert_gemm_bwd_cuda",
                        stand_in("gemm_bwd", gemm_bwd))
    monkeypatch.setattr(ops, "rwkv6_scan_cuda", stand_in("wkv", fwd_bounds))
    monkeypatch.setattr(ops, "rwkv6_scan_bwd_cuda", stand_in(
        "wkv_bwd", ref.rwkv6_bwd_reference))
    for grad in (True, False):
        x = torch.ones((5, 16), requires_grad=grad)
        w = torch.ones((3, 16, 8), requires_grad=grad)
        rkvw = [torch.full((2, 3, 4, 16), 0.5, requires_grad=grad)
                for _ in range(4)]
        u, s0 = torch.zeros((4, 16)), torch.zeros((2, 4, 16, 16))
        calls.clear()
        y = ops.expert_gemm(x, w)
        out, _ = ops.rwkv6_scan(*rkvw, u, s0)
        assert calls == ["gemm", "wkv"] and y.shape == (3, 5, 8)
        if grad:
            torch.autograd.grad(y.sum() + out.sum(), [x, w, *rkvw])
            assert calls[2:] == ["wkv_bwd", "gemm_bwd"] \
                or calls[2:] == ["gemm_bwd", "wkv_bwd"]
        with torch.no_grad():
            calls.clear()
            ops.expert_gemm(x, w)
            assert calls == ["gemm"]
    assert not hasattr(ops, "_no_backward")


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
    dy = torch.zeros((3, 5, 8))
    bounds = torch.zeros((2, 1, 4, 16, 16))
    calls += [
        (expert_gemm, lambda: expert_gemm.expert_gemm_bwd_cuda(x, w, dy)),
        (rwkv6_scan_bwd, lambda: rwkv6_scan_bwd.rwkv6_scan_bwd_cuda(
            rkvw, rkvw, rkvw, rkvw, u, bounds, rkvw, None, chunk=3)),
    ]
    for module, call in calls:
        before = module.launches, getattr(module, "bwd_launches", 0)
        with pytest.raises(ValueError, match="must lie on the card"):
            call()
        assert (module.launches, getattr(module, "bwd_launches", 0)) \
            == before
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
                   decode_attention, flash_attention_bwd, rwkv6_scan_bwd):
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
    (flash_attention_bwd, "flash_attention_bwd_launch"),
    (rwkv6_scan_bwd, "rwkv6_scan_bwd_launch"),
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
                                            rwkv6_scan, decode_attention,
                                            flash_attention_bwd,
                                            rwkv6_scan_bwd)]
    before = {n: build.digest(n) for n in names}
    tc = copy / "attention_tc.cuh"
    tc.write_text(tc.read_text() + "\n// edited\n")
    after = {n: build.digest(n) for n in names}
    assert all(before[n] != after[n] for n in names)


def test_tensor_core_ptx_helpers_live_in_one_header():
    """The ldmatrix, mma.sync, cp.async (and so cp.async.bulk: TMA),
    wgmma and mbarrier wrappers are defined once, in csrc/mma_ptx.cuh, and
    both tensor-core sources and the WKV scan's cp.async ring include
    it."""
    asm = ('"ldmatrix.sync', '"mma.sync', '"cp.async', '"wgmma',
           '"mbarrier')  # inline PTX
    owners = sorted(src.name for src in build.CSRC.glob("*.cu*")
                    if any(op in src.read_text() for op in asm))
    assert owners == ["mma_ptx.cuh"]
    for name in ("attention_tc.cuh", "expert_gemm.cu", "rwkv6_scan.cu"):
        assert '#include "mma_ptx.cuh"' in (build.CSRC / name).read_text()


def _paged(**kw):
    return EngineConfig(**{"cache_layout": "paged", "unified": True,
                           "max_seq": 64, "page_size": 8, **kw})


def _refusal(case: str) -> None:
    """Construct what ``case`` names; each must raise."""
    base = get_reduced("minitron-8b")
    spec = {"swa-paged": get_reduced("mistral-7b-swa"),
            "pp": base.scaled(n_layers=3)}.get(case, base)
    cfg = {"swa-paged": _paged(unified=False),
           "prefix": _paged(prefix_cache=True, unified=False),
           "spec": _paged(n_spec=2),
           "tp": _paged(tp=2, unified=False), "pp": _paged(pp=2)}[case]
    ServeEngine(build_model(spec, device="cpu", dtype=torch.float32), cfg,
                device="cpu")


# an unported mode raises NotImplementedError naming its roadmap item; the
# prefix cache, ported, is refused on the two-dispatch engine, speculation,
# ported, without a draft model, and tp/pp, ported, on the two-dispatch
# engine or with layer repeats pp does not divide, each with the
# reference's ValueError
@pytest.mark.parametrize("case,exc,match", [
    ("swa-paged", NotImplementedError, "ROADMAP: section 3"),
    ("prefix", ValueError, "prefix_cache=True requires unified=True"),
    ("spec", ValueError, "n_spec > 0 needs draft_model"),
    ("tp", ValueError, "tp/pp > 1 requires unified=True"),
    ("pp", ValueError, "pp=2 must divide the stacked layer repeats=3"),
], ids=["swa-paged", "prefix", "spec", "tp", "pp"])
def test_engine_refuses_unported_modes(case, exc, match):
    with pytest.raises(exc, match=match):
        _refusal(case)


def test_model_and_engine_refuse_unported_architectures():
    base = get_reduced("minitron-8b")
    swa = base.scaled(attn=AttnSpec(kind="swa", window=8))
    model = build_model(swa, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        ServeEngine(model, _paged(), device="cpu")
    # Mamba layers are ported: a pure Mamba stack builds, and the engine
    # refuses it only where the reference does (the unified step)
    ssm = base.scaled(n_heads=0, n_kv_heads=0, ssm=SSMSpec())
    model = build_model(ssm, device="cpu", dtype=torch.float32)
    assert {layer.cls.kind for layer in model.layers} == {"mamba"}
    with pytest.raises(ValueError, match="attention-only stacks"):
        ServeEngine(model, _paged(), device="cpu")


def test_paged_two_dispatch_refuses_a_window_only_in_full_precision():
    """The paged two-dispatch decode refuses a sliding window for the
    full-precision model (the reference's kernel route drops the window);
    with the int8 KV cache it takes the reference's gather route, which
    applies it, and the engine builds."""
    swa = get_reduced("minitron-8b").scaled(attn=AttnSpec(kind="swa",
                                                          window=8))
    for quant in (False, True):
        model = build_model(swa, device="cpu", dtype=torch.float32,
                            kv_quant=quant)
        if quant:
            assert ServeEngine(model, _paged(unified=False),
                               device="cpu").paged
            continue
        with pytest.raises(NotImplementedError,
                           match="ROADMAP: section 3"):
            ServeEngine(model, _paged(unified=False), device="cpu")


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
