"""The per-layer metrics that read the program's own spans and counters
(``deepmod_tpu_torch.utils.profiling``): a traced CPU run of a small
detect cell reads them, a traced CPU run of the small train cell reads no
Adam launches (nothing launches on the CPU), and an untraced run reports
none of them."""

import pytest

from conftest import run_cell

DETECT = ("detect_serial_host_ms", "detect_chunk_host_ms",
          "detect_windows_run_per_asked")
TRAIN = "train_adam_launches_per_step"


@pytest.mark.parametrize("cell,twin", [("d_bf16", ""), ("d_fp32", ".fp32")])
def test_a_traced_detect_run_reads_the_program_spans(root, cell, twin,
                                                     capsys):
    rc, line = run_cell(root, cell, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    got = line["metrics"]
    for name in DETECT:
        assert name + twin in got, name
        assert got[name + twin]["value"] > 0
    # pad rows and the bucket's tail: never fewer windows run than asked
    assert got["detect_windows_run_per_asked" + twin]["value"] >= 1.0
    assert got["detect_serial_host_ms" + twin]["unit"] == "ms"


def test_a_traced_train_run_on_the_cpu_reads_no_launches(root, capsys):
    rc, line = run_cell(root, "t_fp32", trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert "train_mfu" in line["metrics"]
    assert TRAIN not in line["metrics"]


@pytest.mark.parametrize("cell", ["d_bf16", "t_fp32"])
def test_an_untraced_run_reports_none_of_them(root, cell, capsys):
    rc, line = run_cell(root, cell, trace=0, capsys=capsys)
    assert rc == 0
    names = set(line["metrics"])
    assert not names & {n + t for n in DETECT + (TRAIN,) for t in ("", ".fp32")}
