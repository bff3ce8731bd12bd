"""The port's head-dim-64 forward variants (K5-K9) and their microbench
against the JAX microbench, on the CPU.

``scripts/microbench_flash_fwd.py`` is loaded from its file and its own
wrappers are called with small blocks (bq = bk = 128) while
``jax.experimental.pallas.pallas_call`` is patched to run in interpret mode,
so the Pallas kernels themselves run on the CPU; no JAX file changes. The
port runs with CPU tensors, which means its plain versions. Inputs are
numpy standard normals rounded to bf16 once and handed to both sides.

Tolerance: rel-Frobenius 1e-2 against the Pallas kernels. The plain
versions take the softmax in one pass where the kernels rescale online over
k blocks, so p is rounded to bf16 at a different running max; at these
sizes the two agree to about 2e-3 (6e-5 for the matmul-only variant, which
has no softmax). K5's, K6's and K7's plain versions, and K9's at Dh 64,
equal the port's plain flash forward (rate 0, non-causal) bit for bit: the
same operations in the same order, as on the card all four run K1's
mainloop.

Also here: ``chip_smoke.ptxas_instances``, which names every kernel
instance of the build's ptxas report, on a sample report;
``chip_smoke.KERNEL_PARAMS``, against the kernel templates the sources
define; and the C signatures ``_build`` binds, against the entry points
each source defines.
"""

import functools
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distributed_llm_training_benchmark_framework_tpu_torch.microbench import flash_fwd as mb
from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import fwd_variants as fv

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "microbench_flash_fwd.py"
BH, S, BLOCK = 4, 256, 128
# Port variant -> the JAX microbench's wrapper of its Pallas kernel.
JAX_WRAPPERS = {
    "fwd_current": "flash_current",
    "fwd_headpair": "flash_headpair",
    "fwd_kt": "flash_kt",
    "fwd_matmul_only": "matmul_floor",
    "fwd_qscaled": "flash_qscaled",
}


@pytest.fixture(scope="module")
def jmb():
    spec = importlib.util.spec_from_file_location("microbench_flash_fwd", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    original = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(original, interpret=True))


def _inputs(d, seed=0):
    """(jax bf16 q, k, v), (torch bf16 q, k, v) holding the same values."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal((BH, S, d)), jnp.bfloat16) for _ in range(3)]
    th = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in jx]
    return jx, th


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", fv.VARIANTS)
def test_plain_matches_pallas_kernel(jmb, interpret, name, d):
    (jq, jk, jv), (q, k, v) = _inputs(d)
    if name == "fwd_kt":
        jk, k = jnp.swapaxes(jk, 1, 2), k.transpose(1, 2).contiguous()
    want = getattr(jmb, JAX_WRAPPERS[name])(jq, jk, jv, bq=BLOCK, bk=BLOCK)
    got = fv.PLAIN[name](q, k, v)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(_np(got), np.asarray(want, np.float32)) <= 1e-2


@pytest.mark.parametrize("d", [64, 128])
def test_sdpa_materialized_matches_xla_sdpa(jmb, d):
    (jq, jk, jv), (q, k, v) = _inputs(d, seed=1)
    want = np.asarray(jmb.xla_sdpa(jq, jk, jv), np.float32)
    assert _rel(_np(fv.sdpa_materialized_plain(q, k, v)), want) <= 1e-2


def test_qscaled_equals_current_bitwise_at_dh64():
    _, (q, k, v) = _inputs(64, seed=2)
    assert torch.equal(fv.fwd_qscaled_plain(q, k, v), fv.fwd_current_plain(q, k, v))


def test_qscaled_rounds_the_scale_to_bf16_at_dh128():
    """bf16(1/sqrt(128)) = 0.08837890625: K9 then differs from K5 by about
    an ulp, as in JAX."""
    assert float(torch.tensor(1 / math.sqrt(128), dtype=torch.bfloat16)) == 0.08837890625
    _, (q, k, v) = _inputs(128, seed=2)
    a, b = fv.fwd_qscaled_plain(q, k, v), fv.fwd_current_plain(q, k, v)
    assert not torch.equal(a, b)
    assert _rel(_np(a), _np(b)) <= 1e-2


@pytest.mark.parametrize("name", fv.VARIANTS)
def test_wrappers_run_the_plain_version_on_cpu(name):
    _, (q, k, v) = _inputs(64, seed=3)
    if name == "fwd_kt":
        k = k.transpose(1, 2).contiguous()
    _build.reset_launch_counts()
    assert torch.equal(fv.WRAPPERS[name](q, k, v), fv.PLAIN[name](q, k, v))
    assert set(fv.launch_counts().values()) == {0}


@pytest.mark.parametrize("name,d", [
    *((name, d) for name in ("fwd_headpair", "fwd_kt", "fwd_current") for d in (64, 128)),
    ("fwd_qscaled", 64),
])
def test_layout_plain_equals_flash_forward_plain(name, d):
    """The identities phase 10 of chip_smoke.py asserts on the card (K5, K6,
    K7 == K1 at rate 0, non-causal; K9 == K5 at Dh 64), held here between
    the plain versions."""
    _, (q, k, v) = _inputs(d, seed=4)
    args = (q, k.transpose(1, 2).contiguous(), v) if name == "fwd_kt" else (q, k, v)
    want, _ = fa.flash_forward_plain(q, k, v, False, 0.0, 0)
    assert torch.equal(fv.PLAIN[name](*args), want)


def _c_entries(source: str) -> dict:
    """{name: parameter count} of every ``extern "C"`` function a csrc file
    defines, directly or through a ``#define ENTRY(NAME, ...)`` macro."""
    text = source.replace("\\\n", " ")
    arity = lambda params: len([p for p in params.split(",") if p.strip()])  # noqa: E731
    entries = {m[1]: arity(m[2])
               for m in re.finditer(r'extern "C" [\w\s*]*?\b(\w+)\(([^)]*)\)', text)}
    for m in re.finditer(r'#define (\w+)\(NAME, \.\.\.\)\s*extern "C" [\w\s*]*?NAME\(([^)]*)\)',
                         text):
        entries.pop("NAME")
        entries.update({n: arity(m[2]) for n in re.findall(rf"^{m[1]}\((\w+),", text, re.M)})
    return entries


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_bind_exactly_the_entries_each_source_defines(lib):
    """ctypes calls an entry with the argument list SIGNATURES gives it: a
    name or a count that drifted from the source would call it wrongly."""
    want = _c_entries((_build.CSRC / f"{lib}.cu").read_text())
    assert {n: len(a) for n, a in _build.SIGNATURES[lib].items()} == want


# ptxas -v as nvcc prints it for the package's kernels: a wgmma mainloop
# instance (K1), a fwd_layout_kernel instance (K6), K9's kernel, K8's kernel
# (given a spill line here, so that the spill parse stays covered), a
# backward instance with its output type, and an entry no template of the
# package names.
PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5flash16flash_fwd_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfifjjf' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash16flash_fwd_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfifjjf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash17fwd_layout_kernelILi128ELb0ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash17fwd_layout_kernelILi128ELb0ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 5 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash18fwd_qscaled_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash18fwd_qscaled_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash17fwd_matmul_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash17fwd_matmul_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16if
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash19flash_bwd_dq_kernelILi64ELb1ELb0EfEEv14CUtensorMap_stS1_S1_S1_PKfS3_PKiS5_S5_Pfiifjjf' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash19flash_bwd_dq_kernelILi64ELb1ELb0EfEEv14CUtensorMap_stS1_S1_S1_PKfS3_PKiS5_S5_Pfiifjjf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function 'other_entry' for 'sm_90a'
ptxas info    : Function properties for other_entry
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 380 bytes cmem[0]
"""


def test_ptxas_instances_names_every_kernel_form():
    none = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    assert chip_smoke.ptxas_instances(PTXAS_SAMPLE.splitlines()) == {
        "flash_fwd_kernel<Dh 64, causal 0, dropout 1>": (96, none),
        "fwd_layout_kernel<Dh 128, k transposed 0, warpgroups 2>": (168, none),
        "fwd_qscaled_kernel<Dh 64>": (90, none),
        "fwd_matmul_kernel<Dh 128>":
            (255, "16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads"),
        "flash_bwd_dq_kernel<Dh 64, causal 1, dropout 0, fp32 out>": (127, none),
        "other_entry": (8, none),
    }


KERNEL_TEMPLATE = re.compile(
    r"template\s*<([^>]*)>\s*__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def test_kernel_params_name_every_kernel_template():
    """Phase 0 of chip_smoke.py names each ptxas instance by KERNEL_PARAMS:
    a kernel renamed, added or given another template parameter in csrc/
    would print under its mangled name or with its arguments mislabelled."""
    templates = {}
    for f in sorted(_build.CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            for m in KERNEL_TEMPLATE.finditer(f.read_text()):
                templates[m[2]] = len([p for p in m[1].split(",") if p.strip()])
    assert templates, "no __global__ template found in csrc/"
    assert {k: len(v) for k, v in chip_smoke.KERNEL_PARAMS.items()} == templates


def _bf16(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("name,args,match", [
    ("fwd_headpair", (_bf16(3, 128, 64),) * 3, "even"),
    ("fwd_current", (_bf16(2, 96, 64),) * 3, "multiple of the tile"),
    ("fwd_current", (_bf16(2, 128, 32),) * 3, "head dim 32"),
    ("fwd_current", (_bf16(2, 128, 64, dtype=torch.float32),) * 3, "bfloat16"),
    ("fwd_current", (_bf16(2, 64, 128).transpose(1, 2),) * 3, "contiguous"),
    ("fwd_kt", (_bf16(2, 128, 64),) * 3, "expected"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(name, args, match):
    with pytest.raises(ValueError, match=match):
        fv.WRAPPERS[name](*args)


def test_headpair_plain_refuses_odd_bh():
    x = _bf16(3, 64, 64)
    with pytest.raises(ValueError, match="even"):
        fv.fwd_headpair_plain(x, x, x)


def test_microbench_runs_every_variant_on_cpu(capsys):
    rows = mb.main(["--device", "cpu", "--bh", "2", "--seq", "128"])
    out = capsys.readouterr().out
    names = [r["name"] for r in rows]
    assert names == ["matmul_floor", "flash_current", "flash_headpair", "flash_kt",
                     "flash_qscaled", "flash_production", "sdpa_materialized", "torch_sdpa"]
    for r in rows:
        assert r["ms"] is None and r["pct_peak"] is None and math.isfinite(r["max_abs"])
        assert r["launches"] == 0
        line = next(ln for ln in out.splitlines() if ln.startswith(r["name"] + " "))
        assert "time not measured" in line and "share of peak not measured" in line
        assert " ms " not in line
    # The attention variants agree with the materialized reference.
    assert all(r["max_abs"] <= 2e-2 for r in rows if r["ref"] == "sdpa_materialized")


def test_microbench_raises_without_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.main(["--bh", "2", "--seq", "128"])


@pytest.mark.parametrize("argv", [["--seq", "100"], ["--bh", "3"], ["--dim", "32"]])
def test_microbench_refuses_what_the_kernels_do_not_take(argv):
    with pytest.raises(SystemExit):
        mb.main(["--device", "cpu", *argv])
