"""The port's quickstart (``python -m repro_torch.examples.quickstart``)
at a reduced size on the CPU: one fit, every declared target met within
the conformance tolerance."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.examples import quickstart  # noqa: E402

TOL = 0.03


def test_quickstart_meets_every_target(capsys):
    out = quickstart.main(n=6000, dim=16, learn=400, queries=64,
                          clusters=32, nlist=32, device="cpu")
    printed = capsys.readouterr().out
    assert "Every target met from ONE fit" in printed
    assert set(out["targets"]) == set(quickstart.TARGETS)
    for target, row in out["targets"].items():
        assert row["recall"] >= target - TOL, (target, row)
        assert row["ndis"] <= out["plain"]["ndis"]
        assert f"{target:7.2f} {row['recall']:7.3f}" in printed
