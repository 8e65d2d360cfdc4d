"""The work-based byte counts of K1 and K2 at the shapes of PERF.md's kernel
table, each beside that table's bound and why they differ: the table's
bounds count what today's kernels move (a one-hot label matrix, whole
count tables written out, int32 bin ids, per-row deltas); the benchmark's
counts take each input once as handed and only the state cells that the
batch reaches, so no later design can pass 100 %."""
import pytest
import torch

from benchmark.harness import profiling, roofline

KERNELS = roofline.kernels()
K1, K2 = KERNELS["k1"], KERNELS["k2"]
NAMES = {key: module.NAMES for key, module in KERNELS.items()}

RATE = 3.35e12  # bytes/s, H100 SXM


def _class_batch(n=1024, c=1000, seed=0):
    g = torch.Generator().manual_seed(seed)
    target = torch.randint(0, c, (n,), generator=g)
    logits = torch.randn((n, c), generator=g)
    logits[torch.arange(n), target] += 4.0
    return torch.softmax(logits, dim=1), target


def test_k1_many_classes_counts_ids_not_a_one_hot_matrix():
    preds, target = _class_batch()
    got = K1.work_bytes((preds, target), {}, thresholds=100)
    inputs = 1024 * 1000 * 4 + 1024 * 8 + 100 * 4  # scores, int64 ids, thresholds
    cells = (got - inputs) // 4
    # the cells the rows reach: at least one (class, bin, label) per class, at most every one
    assert 1000 <= cells <= 1000 * 101 * 2
    table_bound = 1024 * 1000 * 4 + 1024 * 1000 + 3 * 1000 * 100 * 4  # PERF.md: 6.32 MB, 0.00189 ms
    assert got < table_bound
    assert abs(table_bound / RATE * 1e3 - 0.00189) < 5e-5
    print(f"K1 N=1024 C=1000 T=100: {got} bytes ({got / RATE * 1e3:.6f} ms) against the table's {table_bound} (0.00189 ms)")


def test_k1_one_class_many_rows_counts_the_masks_as_bytes():
    n = 1 << 24
    g = torch.Generator().manual_seed(1)
    scores, masks = torch.rand(n, generator=g), (torch.rand(n, generator=g) < 0.05).to(torch.uint8)
    got = K1.work_bytes((scores, masks), {}, thresholds=100)
    cells = (got - (n * 4 + n + 400)) // 4
    assert 2 <= cells <= 202
    table_bound = 83_886_080 + 1200  # PERF.md: 83.9 MB (scores, uint8 labels, the counts), 0.025041 ms
    assert abs(got - table_bound) < 2000
    print(f"K1 2^24 rows C=1: {got} bytes ({got / RATE * 1e3:.6f} ms) against the table's 0.025041 ms")


def test_k2_counts_one_byte_an_id_at_four_bins():
    n = 1 << 24
    g = torch.Generator().manual_seed(2)
    scores, masks = torch.rand(n, generator=g), (torch.rand(n, generator=g) < 0.05).to(torch.uint8)
    got = K2.work_bytes((scores, masks), {}, num_classes=2)
    assert got == n * 1 + 4 * 4
    table_bound = n * 4  # PERF.md: int32 ids over 2051 bins, 0.02003 ms
    assert got < table_bound
    assert roofline.id_width(2051) == 2 and roofline.id_width(4) == 1 and roofline.id_width(10 ** 6) == 4
    print(f"K2 2^24 ids, 4 bins: {got} bytes ({got / RATE * 1e3:.6f} ms) against the table's 0.02003 ms (int32 ids)")


def test_k1_cohort_batch_counts_the_cells_not_the_deltas():
    preds, target = _class_batch(seed=3)
    ids = torch.randint(0, 256, (1024,), generator=torch.Generator().manual_seed(4))
    got = K1.work_bytes((preds, target), {"slice_ids": ids}, thresholds=100)
    plain = K1.work_bytes((preds, target), {}, thresholds=100)
    assert got > plain  # the cohort ids, and the cells split by cohort
    deltas = 1024 * 3 * 1000 * 100 * 4  # PERF.md's one-row lanes: 1.23 GB out, 0.3683 ms
    assert got < deltas / 100
    print(f"K1 cohort batch: {got} bytes ({got / RATE * 1e3:.6f} ms) against the deltas' 0.3683 ms")


def test_peaks_and_kernel_names():
    assert roofline.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == RATE
    assert roofline.peak("cpu") is None
    assert roofline.kernel_of("void (anonymous namespace)::binned_counters_flat_kernel<false>(float const*)", NAMES) == "k1"
    assert roofline.kernel_of("void (anonymous namespace)::histogram_kernel<true, false>(int const*)", NAMES) == "k2"
    assert roofline.kernel_of("void compactor_cascade_kernel(float*)", NAMES) == "k3"
    assert roofline.kernel_of("void at::native::vectorized_elementwise_kernel<4>", NAMES) is None


def _segment(first_batch, updates, records_per_update):
    """A made-up profiled segment: ``updates`` update ranges of 10 us, each
    with ``records_per_update`` K1 records that together take 4 us."""
    ranges, device = [], []
    for u in range(updates):
        ranges.append(("update", 10.0 * u, 10.0 * u + 10))
        for r in range(records_per_update):
            lo = 10.0 * u + 1 + r * 4 / records_per_update
            device.append((f"binned_counters_part{r}_kernel", lo, lo + 4 / records_per_update))
    ranges += [("drain", 10.0 * updates, 10.0 * updates + 5), ("compute", 10.0 * updates + 5, 10.0 * updates + 9)]
    return {"ranges": ranges, "device": device, "first_batch": first_batch}


@pytest.mark.parametrize("records_per_update", [1, 2])
def test_the_share_is_credited_per_update_not_per_launch(records_per_update):
    # an epoch of five updates whose K1 work differs; two segments from the third update on
    per_batch = {"k1": [100, 200, 300, 400, 50]}
    segments = [_segment(2, 3, records_per_update), _segment(2, 3, records_per_update)]
    work = roofline.traced_work(per_batch, segments)
    assert work == {"k1": 2.0 * (300 + 400 + 50)}
    prof = profiling.summarize(segments, NAMES)
    assert prof["kernel_s"]["k1"] == pytest.approx(2 * 3 * 4e-6)
    # the same work in two launches an update reads the same share as in one
    got = roofline.share(work["k1"], prof["kernel_s"]["k1"], "NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(100.0 * 1500 / RATE / 24e-6)
    assert roofline.share(work["k1"], None, "NVIDIA H100 80GB HBM3") is None
    assert roofline.share(work["k1"], 1.0, "cpu") is None


def test_members_state_their_kernels_work():
    from types import SimpleNamespace

    preds, target = _class_batch(n=64, c=10)
    data = SimpleNamespace(args=(preds, target), kwargs={}, batches=[(0, 32), (32, 64)])
    data.batch = lambda i: ((preds[data.batches[i][0]:data.batches[i][1]], target[data.batches[i][0]:data.batches[i][1]]), {})
    members = {"acc": {"kernels": {}}, "bap": {"kernels": {"k1": {"thresholds": 100}}}, "bap2": {"kernels": {"k1": {"thresholds": 100}}}}
    got = roofline.batch_work(data, members, KERNELS)
    one = [K1.work_bytes(data.batch(i)[0], {}, thresholds=100) for i in range(2)]
    assert got == {"k1": [2 * one[0], 2 * one[1]]}
