"""The port's roofline (``core/roofline.py``) and dry-run report
(``launch/report.py``) against ``repro``'s.

* ``link_bytes`` equals the link bytes ``repro``'s
  ``collective_stats_from_hlo`` gives one hand-written HLO line of each
  collective kind, at group sizes 1, 2 and 16;
* ``roofline_report`` fed the counts of ``repro``'s ``analyze_hlo_text``
  (a small ``jax.jit`` program compiled on the CPU) gives the reference
  report's every field and its ``as_row``;
* ``report.py`` renders one fixed JSONL (single-pod, multi-pod, error
  and skipped rows) byte for byte as ``repro.launch.report`` does.
"""
import contextlib
import dataclasses
import io
import json
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hw as jhw  # noqa: E402
from repro.core import roofline as jroof  # noqa: E402
from repro.core.hlo_analysis import analyze_hlo_text  # noqa: E402
from repro.launch import report as jreport  # noqa: E402

from repro_torch.core import hw  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.launch import report  # noqa: E402

# One line of optimized HLO per collective kind; {g} is the group size,
# {groups} its replica groups.  The result shape is the raw bytes.
HLO_LINES = {
    "all-gather": "%ag = bf16[64,128]{{1,0}} all-gather(bf16[{part},128]{{1,0}}"
                  " %p), channel_id=1, replica_groups={groups}, dimensions={{0}}",
    "all-reduce": "%ar = f32[32,256]{{1,0}} all-reduce(f32[32,256]{{1,0}} %p),"
                  " channel_id=2, replica_groups={groups}, to_apply=%add",
    "reduce-scatter": "%rs = f32[{part},256]{{1,0}} reduce-scatter(f32[64,256]"
                      "{{1,0}} %p), channel_id=3, replica_groups={groups}, "
                      "dimensions={{0}}, to_apply=%add",
    "all-to-all": "%a2a = bf16[64,64]{{1,0}} all-to-all(bf16[64,64]{{1,0}} %p),"
                  " channel_id=4, replica_groups={groups}, dimensions={{0}}",
    "collective-permute": "%cp = bf16[16,512]{{1,0}} collective-permute("
                          "bf16[16,512]{{1,0}} %p), channel_id=5, "
                          "source_target_pairs={{{{0,1}},{{1,0}}}}",
}


def _line(kind: str, g: int) -> str:
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    return "  " + HLO_LINES[kind].format(groups=groups, part=64 // g)


@pytest.mark.parametrize("g", [1, 2, 16])
@pytest.mark.parametrize("kind", list(HLO_LINES))
def test_link_bytes_matches_reference_hlo_accounting(kind, g):
    line = _line(kind, g)
    ref = jroof.collective_stats_from_hlo(line, n_chips=g)
    assert ref.counts == {kind: 1}
    raw = ref.op_bytes[kind]
    assert roofline.link_bytes(kind, raw, g) == ref.link_bytes_per_chip
    # The analyzer behind the reference's roofline_report, on the same
    # line: its raw bytes are the result's alone (the parser above also
    # counts the operand of a non-tuple result), its factor the same.
    st = analyze_hlo_text(f"ENTRY %main () -> f32[] {{\n{line}\n}}\n", g)
    assert st.coll_counts == {kind: 1}
    assert roofline.link_bytes(kind, st.coll_bytes[kind], g) == \
        st.coll_link_bytes


def test_link_bytes_refuses_unknown_op():
    with pytest.raises(ValueError):
        roofline.link_bytes("all-gather-start", 1.0, 2)


def test_dtype_bytes_and_torch_names():
    import torch
    assert roofline.DTYPE_BYTES == jroof.DTYPE_BYTES
    for dt, name in roofline.TORCH_DTYPE_NAMES.items():
        assert roofline.DTYPE_BYTES[name] == torch.empty((), dtype=dt
                                                         ).element_size()


def _dot(a, b):
    return jnp.tanh(a @ b) @ b.T


def _elementwise(x):
    return x * 2.0 + 1.0


CASES = {
    "dot": (_dot, [jax.ShapeDtypeStruct((256, 512), jnp.float32),
                   jax.ShapeDtypeStruct((512, 128), jnp.float32)]),
    # No dot: the report falls back on the analytic FLOPs.
    "elementwise": (_elementwise,
                    [jax.ShapeDtypeStruct((1024, 1024), jnp.float32)]),
}


# The default model, and one with other peaks and no link count (the
# report takes at least one link).
HW = {"TPU_V5E": {}, "other": dict(peak_flops=989e12, hbm_bandwidth=3.35e12,
                                   ici_bandwidth=450e9, ici_links_per_axis=0)}


@pytest.mark.parametrize("n_chips,mesh", [(1, "1"), (256, "16x16"),
                                          (512, "2x16x16")])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hw_name", list(HW))
def test_roofline_report_matches_reference(case, n_chips, mesh, hw_name):
    fn, args = CASES[case]
    compiled = jax.jit(fn).lower(*args).compile()
    text = compiled.as_text()
    cost = compiled.cost_analysis()
    kw = dict(arch="smollm-360m", shape="train_4k", mesh_name=mesh,
              n_chips=n_chips, model_flops=3.0e9, analytic_flops=4.5e9,
              cost_analysis=cost)
    jmodel = dataclasses.replace(jhw.TPU_V5E, **HW[hw_name])
    model = dataclasses.replace(hw.TPU_V5E, **HW[hw_name])
    assert dataclasses.asdict(model) == dataclasses.asdict(jmodel)
    want = jroof.roofline_report(hlo_text=text, hw=jmodel, **kw)
    got = roofline.roofline_report(stats=analyze_hlo_text(text, n_chips),
                                   hw=model, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.as_row() == want.as_row()
    if case == "elementwise":
        assert "flops=analytic" in got.notes


ROWS = [
    {"arch": "smollm-360m", "shape": "train_4k", "mesh": "16x16",
     "strategy": "auto", "kind": "train", "chips": 256, "compile_s": 29.7,
     "memory_analysis": {"temp_size_in_bytes": 2454042244,
                         "argument_size_in_bytes": 808347012,
                         "output_size_in_bytes": 799958416,
                         "generated_code_size_in_bytes": None},
     "hlo_flops": 5.2446e15, "hlo_bytes": 4.4544e14,
     "coll_link_bytes_per_chip": 2.2877e9,
     "coll_counts": {"all-gather": 5, "all-reduce": 3},
     "compute_ms": 104.0, "memory_ms": 2124.7, "collective_ms": 22.9,
     "dominant": "memory", "model_flops": 2.57e15, "useful_ratio": 0.4906,
     "notes": "", "decisions": {"layout": "flat_dp"}},
    {"arch": "smollm-360m", "shape": "decode_32k", "mesh": "16x16",
     "strategy": "auto", "kind": "decode", "chips": 256, "compile_s": 3.5,
     "memory_analysis": {"temp_size_in_bytes": 263884760960,
                         "argument_size_in_bytes": 674291864,
                         "output_size_in_bytes": None,
                         "generated_code_size_in_bytes": None},
     "hlo_flops": 9.728e12, "hlo_bytes": 1.705e14,
     "coll_link_bytes_per_chip": 1.7194e11, "coll_counts": {"all-gather": 26},
     "compute_ms": 0.193, "memory_ms": 813.3, "collective_ms": 1719.4,
     "dominant": "collective", "model_flops": 1.05e11,
     "useful_ratio": 0.0108, "notes": "", "decisions": {}},
    {"arch": "granite-moe-1b-a400m", "shape": "train_4k", "mesh": "2x16x16",
     "strategy": "tp", "kind": "train", "chips": 512, "compile_s": 123.4,
     "memory_analysis": {}, "hlo_flops": 1.96e17, "hlo_bytes": 3.1e15,
     "coll_link_bytes_per_chip": 4.0e10,
     "coll_counts": {"all-gather": 20, "all-reduce": 5},
     "compute_ms": 1945.0, "memory_ms": 7390.0, "collective_ms": 400.0,
     "dominant": "memory", "model_flops": 2.4e15, "useful_ratio": 0.0122,
     "notes": "flops=analytic", "decisions": {"layout": "tp"}},
    {"arch": "llama4-maverick-400b-a17b", "shape": "prefill_32k",
     "mesh": "16x16", "strategy": "auto",
     "error": "RuntimeError: out of memory", "traceback": "Traceback ..."},
    {"arch": "smollm-360m", "shape": "long_500k", "skipped": True,
     "reason": "pure full-attention arch; long_500k requires sub-quadratic "
               "mixing (DESIGN.md §4)"},
]


@pytest.fixture
def results(tmp_path):
    path = tmp_path / "dryrun_results.jsonl"
    with open(path, "w") as f:
        for r in ROWS:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    return str(path)


def _main_output(module, path, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["report", path])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return buf.getvalue()


def test_report_renders_byte_equal(results, monkeypatch):
    rows = report.load(results)
    assert rows == jreport.load(results) and len(rows) == len(ROWS)
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(rows, mesh) == \
            jreport.roofline_table(rows, mesh)
    assert report.dryrun_table(rows) == jreport.dryrun_table(rows)
    got = _main_output(report, results, monkeypatch)
    assert got == _main_output(jreport, results, monkeypatch)
    assert "granite-moe-1b-a400m | train_4k | 2x16x16" in got
    assert "Skipped cells" in got and "llama4" not in got
    for x in (0.5, 12.0, 4321.0, 250_000.0):
        assert report.fmt_ms(x) == jreport.fmt_ms(x)
