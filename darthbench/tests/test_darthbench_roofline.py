"""The roofline's byte and operation counts against hand-worked values on
a tiny index, and the reduction of profiler events to busy and idle time."""
import types

import pytest
import torch

from darthbench import profiling, roofline


def test_probe_counts_on_a_tiny_store():
    # 3 buckets of cap 4 holding 4, 2 and 0 live rows; 4 queries, the
    # last inactive; width 2, f32 codes, k 1.
    live = torch.tensor([4, 2, 0])
    slot = torch.tensor([[0, 0, 1, 2]])
    active = torch.tensor([[True, True, True, False]])
    c = roofline.probe_counts(slot, active, live, cap=4, dim=2,
                              code_bytes=4, k=1)
    # distinct buckets read: 0 and 1 -> ids 4 x 4 x 2 = 32; live rows
    # 4 + 2 = 6 -> 6 x (2 x 4 + 4) = 72; own inputs and top-k of the 3
    # active queries 3 x (4 x 2 + 12 + 16 + 4) = 120; 4 active flags.
    assert float(c["bytes"][0]) == 32 + 72 + 120 + 4
    # scanned live rows 4 + 4 + 2 = 10, 2 x width each
    assert float(c["flops"][0]) == 2 * 2 * 10
    pk = {"bytes_per_s": 1.0e3, "f32_flop_per_s": 1.0e1}
    assert roofline.probe_least_s(c, pk) == pytest.approx(max(0.228, 4.0))


def test_probe_counts_sum_calls_row_by_row():
    live = torch.tensor([3, 5])
    slot = torch.tensor([[0, 1], [1, 1]])
    active = torch.tensor([[True, True], [True, False]])
    c = roofline.probe_counts(slot, active, live, cap=8, dim=4,
                              code_bytes=1, k=2)
    own = 4 * 4 + 12 + 16 * 2 + 4
    assert c["bytes"].tolist() == [4 * 8 * 2 + 8 * (4 + 4) + 2 * own + 2,
                                   4 * 8 + 5 * (4 + 4) + own + 2]
    assert c["flops"].tolist() == [2 * 4 * 8, 2 * 4 * 5]


def test_gbdt_counts_by_hand():
    c = roofline.gbdt_counts(rows=5, features=11, trees=3, depth=2)
    # 3 internal nodes (feature + threshold) and 4 leaves a tree
    assert c["bytes"] == 4 * 5 * 11 + 4 * 3 * (3 + 3 + 4) + 4 * 5
    assert c["flops"] == 5 * 3 * 3


def test_peaks_are_the_data_sheet_and_unknown_cards_get_none():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bytes_per_s"] == 3.35e12 and pk["f32_flop_per_s"] == 67e12
    assert roofline.peaks("cpu") is None


def _ev(name, start, end, device, thread=1):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        thread=thread)


def test_reduce_counts_busy_idle_kernels_and_labels_gaps():
    events = [
        _ev("spin_kernel", 0, 10, True),
        _ev("void (anonymous namespace)::probe_tile_kernel<float>(int)",
            20, 30, True),
        _ev("void gbdt_predict_kernel(Args)", 25, 35, True),
        _ev("Memcpy DtoH", 60, 70, True),
        _ev("aten::nonzero", 36, 58, False),
        _ev("serve", 0, 100, False),
        _ev(profiling.END_MARK, 80, 81, False),
    ]
    s = profiling.reduce(events)
    assert s.window_s == pytest.approx(70e-6)       # spin end 10 to mark 80
    assert s.busy_s == pytest.approx(25e-6)         # 20-35 and 60-70
    assert s.kernel_s["bucket_probe"] == pytest.approx(10e-6)
    assert s.kernel_launches == {"bucket_probe": 1, "gbdt_predict": 1}
    labels = dict(s.idle_gaps)
    assert labels["aten::nonzero"] == pytest.approx(25e-6)   # 35-60
    assert labels["serve"] == pytest.approx(20e-6)           # 10-20, 70-80
    assert dict(s.device_ops)["probe_tile_kernel<float>"] == pytest.approx(
        10e-6)


def test_reduce_without_device_events_reads_nothing():
    assert profiling.reduce([_ev("aten::add", 0, 1, False)]) is None
