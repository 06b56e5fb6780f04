"""The frozen work formulas against counts made by hand at small shapes,
and the reading of a trace on events made up for it."""
import types

import pytest

from kgebench.yardstick import peaks, readers, trace, work


def test_basis_message_by_hand():
    e, nb, d_in, d_out, on = 5, 2, 3, 4, 3
    # per on-edge and basis: a d_in x d_out product (d_in mul-adds per
    # output) and the coefficient's multiply-add per output
    ops = on * nb * d_out * (2 * d_in + 2)
    assert work.basis_message_ops(e, nb, d_in, d_out, on) == ops
    assert work.basis_message_ops(e, nb, d_in, d_out) == \
        e * nb * d_out * (2 * d_in + 2)
    read = 4 * (e * d_in + e * nb + nb * d_in * d_out) + e
    assert work.basis_message_bytes(e, nb, d_in, d_out) == \
        read + 4 * e * d_out


def test_kge_score_and_topk_by_hand():
    b, c, d, k = 3, 7, 5, 2
    assert work.kge_score_ops(b, c, d) == b * c * d * 2
    # unfiltered: q, candidates, the row and column bias vectors, scores
    assert work.kge_score_bytes(b, c, d) == \
        4 * (b * d + c * d + b + c) + 4 * b * c
    # filtered: the (B, C) bias of known tails read as well
    assert work.kge_score_bytes(b, c, d, filtered=True) == \
        4 * (b * d + c * d + b + c + b * c) + 4 * b * c
    assert work.topk_scores_bytes(b, c, k) == 4 * b * c + b * k * (4 + 8)
    assert work.topk_scores_bytes(b, c, k, with_ids=True) == \
        4 * b * c + b * k * (4 + 8) + 8 * b * k
    assert work.serve_step_ops(b, c, d) == b * d + 2 * b * c * d


def test_train_step_by_hand():
    n_on, v, c, nb, d, s = 6, 4, 3, 2, 5, 1
    layer = (n_on * nb * d * (2 * d + 2)      # basis messages
             + n_on * d + v * d               # their sum, the mean
             + 2 * v * d * d + v * d)         # self loop and its add
    decoder = 3 * d * c * (1 + s)
    want = 3 * (2 * layer + decoder)
    got = work.kge_train_step_ops([(n_on, v, c)], [(d, d), (d, d)], nb, d, s)
    assert got == want
    two = work.kge_train_step_ops([(n_on, v, c)] * 2, [(d, d), (d, d)], nb,
                                  d, s)
    assert two == 2 * want


def test_bound_picks_the_larger():
    t, which = peaks.bound_s(3.35e12, 1.0)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = peaks.bound_s(1.0, 67e12 * 2)
    assert which == "operations" and t == pytest.approx(2.0)


def _event(eid, name, start, end, device):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        id=eid, name=name,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_summarize_busy_idle_and_names():
    pad = 2
    ev = []
    t = 0.0
    # pads, then 3 kernels with a 50 us gap while the host runs "aten::x"
    for i in range(pad):
        ev += [_event(i, "cudaLaunchKernel", t, t + 1, False),
               _event(i, "void pad_kernel<1>(float*)", t + 1, t + 2, True)]
        t += 3
    ev.append(_event(100, "aten::x", 30, 120, False))
    for j, (lo, hi) in enumerate(((10, 20), (15, 25), (75, 80))):
        ev += [_event(10 + j, "cudaLaunchKernel", lo - 1, lo, False),
               _event(10 + j, "void basis_message_kernel<4>(float const*)",
                      lo, hi, True)]
    t = 200.0
    for i in range(pad):
        ev += [_event(50 + i, "cudaLaunchKernel", t, t + 1, False),
               _event(50 + i, "pad_kernel", t + 1, t + 2, True)]
        t += 3
    prof = types.SimpleNamespace(events=lambda: ev)
    s = trace.summarize(prof, window_s=1e-4, pad=pad)
    assert s.count("basis_message_kernel") == 3
    assert s.seconds("basis_message_kernel") == pytest.approx(25e-6)
    assert s.busy_s == pytest.approx(20e-6)       # [10, 25] and [75, 80]
    assert s.idle_by_host == {"aten::x": pytest.approx(50e-6)}
    assert s.lost == 0
    assert readers.idle_share({"trace": s}) == pytest.approx(80.0)
    assert "pad_kernel" not in s.seconds_by_name


def test_roofline_refuses_a_miscount():
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5,
                           seconds_by_name={"k": 2e-3},
                           count_by_name={"k": 2}, idle_by_host={}, lost=0)
    calls = [(3.35e9, 0.0)] * 2            # 1 ms each by bytes
    assert readers.roofline({"trace": s}, ("k",), calls) == \
        pytest.approx(100.0)
    with pytest.raises(ValueError):
        readers.roofline({"trace": s}, ("k",), calls * 2)
    assert readers.roofline({"trace": None}, ("k",), calls) is None
