"""The port's solve profiler (conicip_tpu_torch.trace), on the CPU.

Its measurements need a card; what runs here is how it reduces a trace:
device busy time as the union of event intervals, and kernel names grouped
by the Cholesky kernel's parts.
"""

import numpy as np
import pytest
import torch

import conicip_tpu_torch as pt
from conicip_tpu_torch import trace
from conicip_tpu_torch.solver import resolve_factor_dtype


@pytest.mark.parametrize("events, busy", [
    ([], 0.0),
    ([{"ts": 0, "dur": 5}], 5.0),
    # overlapping and nested intervals count once, gaps not at all
    ([{"ts": 3, "dur": 4}, {"ts": 0, "dur": 5}, {"ts": 10, "dur": 1}], 8.0),
    ([{"ts": 0, "dur": 10}, {"ts": 2, "dur": 3}], 10.0),
])
def test_busy_is_the_union_of_intervals(events, busy):
    assert trace._busy_us(events) == busy


def test_kernel_names_group_by_cholesky_part():
    assert trace._kernel_name(
        "void (anonymous namespace)::factor_diag<double>(double const*, "
        "double*, double*, int, int, int, unsigned int const*, unsigned int)"
    ) == "factor_diag"
    assert trace._kernel_name(
        "void (anonymous namespace)::trailing_update<float>(float*, int)"
    ) == "trailing_update"
    other = "void at::native::vectorized_elementwise_kernel<4>(int, float)"
    assert trace._kernel_name(other) == other.split("(")[0]


def test_kernel_names_group_the_jacobi_kernels_and_spot_cusolver():
    assert trace._kernel_name(
        "void (anonymous namespace)::eigh_jacobi<float>(float const*, "
        "float*, float*, double*, int, int, int)") == "eigh_jacobi"
    assert trace._kernel_name(
        "void (anonymous namespace)::svd_jacobi<double>(double const*, "
        "double*, double*, double*, int, int, int)") == "svd_jacobi"
    assert trace._kernel_name(
        "void (anonymous namespace)::eigh_jacobi_warp<double, 30, true>("
        "double const*, double*, double*, int, int, int)"
    ) == "eigh_jacobi_warp"
    assert trace._kernel_name(
        "void (anonymous namespace)::svd_jacobi_warp<float, 0>(float "
        "const*, float*, float*, int, int, int)") == "svd_jacobi_warp"
    for name in ("void syevj_batch_parallel_jacobi_kernel<double>(int)",
                 "void batched_svd_parallel_jacobi_32x16<double, double>()",
                 "void sytrd_lower_kernel<float>(int)"):
        assert trace._is_cusolver_eig_svd(name)
    assert not trace._is_cusolver_eig_svd(
        "void (anonymous namespace)::eigh_jacobi<double>(double const*)")


def test_loop_counts_read_the_device_loop_ranges():
    # a copy and a launch are placed by the host call they came from
    # (correlation ids): inside the loop's range or not, inside its replays
    # or not
    from conicip_tpu_torch.solver import graph

    def host(name, ts, corr):
        return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def copy(corr):
        return {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
                "Pageable)", "ts": 500, "dur": 1,
                "args": {"correlation": corr}}

    events = [
        {"cat": "user_annotation", "name": graph.LOOP, "ts": 10, "dur": 90},
        {"cat": "user_annotation", "name": graph.REPLAY, "ts": 50,
         "dur": 40},
        host("cudaMemcpyAsync", 5, 1), copy(1),  # before the loop
        host("cudaLaunchKernel", 20, 2),  # the first chunk, eager
        host("cudaMemcpyAsync", 30, 3), copy(3),  # its poll
        host("cudaGraphLaunch", 60, 4),
        host("cudaMemcpyAsync", 70, 5), copy(5),  # a replay's poll
        host("cudaLaunchKernel", 80, 6),  # a launch during the replays
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 1, "dur": 1, "args": {"correlation": 7}},
        host("cudaMemcpyAsync", 95, 7),
    ]
    assert trace.loop_counts(events) == dict(
        dtoh_loop=2, dtoh_fixed=1, replay_host_launches=1)


def test_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    assert trace.main(["--n", "8"]) == 2
    assert trace.main(["--family", "larger_sdp"]) == 2
    assert trace.main(["--n", "8", "--factor-dtype", "float32"]) == 2


def test_families_make_their_problems():
    assert sorted(trace.FAMILIES) == ["box_qp_dense", "larger_sdp",
                                      "many_small_socs", "mixed_rq_eq",
                                      "mixed_rqs", "readme_box", "rq_eq",
                                      "single_soc"]
    P = trace.FAMILIES["single_soc"](8, 42)
    assert P.name == "single_soc(n=8)" and P.cone_dims == [("Q", 9)]
    assert trace.FAMILIES["box_qp_dense"](8, 42).A.shape == (16, 8)
    assert trace.FAMILIES["larger_sdp"](8, 42).cone_dims == [("S", 465)]
    box = trace.FAMILIES["readme_box"](8, 42)
    assert box.A.shape == (16, 8) and np.array_equal(box.Q, 0.5 * np.eye(8))


def test_the_custom_kkt_and_verbose_switches():
    # --kkt custom: the example's box solver (a caller's own callable) on
    # the README box QP; on the CPU the device loop takes it and gives the
    # package's diag backend's answer. --verbose solves one instance.
    args = trace.parse_args(["--family", "readme_box", "--kkt", "custom",
                             "--verbose"])
    assert args.kkt == "custom" and args.verbose
    for bad in (["--kkt", "custom"], ["--verbose", "--batch", "4"]):
        with pytest.raises(SystemExit):
            trace.parse_args(bad)
    kkt = trace.kktsolver("custom", "float64", "cpu")
    P = trace.FAMILIES["readme_box"](30, 7)
    sol = pt.conic_ip(*P.args(), kktsolver=kkt, device="cpu")
    run = pt.solver.runs[-1]
    ref = pt.conic_ip(*P.args(), device="cpu")
    assert run.loop == "chunks" and sol.status == ref.status == "Optimal"
    assert float((sol.y - ref.y).abs().max()) < 1e-6
    assert trace.kkt_builds(run) == 1 + run.fast_steps


def test_factor_dtype_switch_selects_the_solve():
    assert trace.parse_args([]).factor_dtype == "float64"
    assert trace.parse_args(["--factor-dtype", "float32"]).factor_dtype == \
        "float32"
    # the default is conic_ip's own default, full-precision factors
    assert resolve_factor_dtype(trace.FACTOR_DTYPES["float64"]) is None
    assert trace.FACTOR_DTYPES["float32"] is torch.float32
    with pytest.raises(SystemExit):
        trace.parse_args(["--factor-dtype", "bfloat16"])


def test_batch_switch_profiles_a_stacked_solve():
    assert trace.parse_args([]).batch == 0
    args = trace.parse_args(["--batch", "64", "--n", "500"])
    assert (args.batch, args.family) == (64, "box_qp_dense")
    Q, c, A, b, cones = trace.BATCH_FAMILIES["box_qp_dense"](3, 8, 42)
    assert Q.shape == (3, 8, 8) and A.shape == (3, 16, 8)
    out = trace.BATCH_FAMILIES["mixed_rq_eq"](2, 0, 42)
    assert out[0].shape == (2, 200, 200) and out[5].shape == (10, 200)
    assert sorted(trace.BATCH_FAMILIES) == ["box_qp_dense", "mixed_rq_eq",
                                            "mixed_rqs", "small_sdp"]
    # a family without the form asked for is refused
    with pytest.raises(SystemExit):
        trace.parse_args(["--batch", "8", "--family", "single_soc"])
    with pytest.raises(SystemExit):
        trace.parse_args(["--family", "small_sdp"])
    if not torch.cuda.is_available():
        assert trace.main(["--batch", "4", "--n", "8"]) == 2


def test_chain_switch_solves_seeded_instances():
    assert trace.parse_args([]).chain == 0
    args = trace.parse_args(["--chain", "6", "--family", "single_soc"])
    assert (args.chain, args.family) == (6, "single_soc")
    # the instances differ: one seed each
    a, b = (trace.FAMILIES["single_soc"](8, s) for s in (42, 43))
    assert a.A.shape == b.A.shape and not (a.c == b.c).all()
    # a chain of stacks: K stacks of B, one seed each
    args = trace.parse_args(["--chain", "6", "--batch", "64", "--family",
                             "mixed_rq_eq"])
    assert (args.chain, args.batch, args.family) == (6, 64, "mixed_rq_eq")
    a, b = (trace.BATCH_FAMILIES["small_sdp"](3, 0, s) for s in (42, 43))
    assert a[0].shape == b[0].shape and not (a[1] == b[1]).all()
    assert trace.ROUNDS >= 5
    if not torch.cuda.is_available():
        assert trace.main(["--n", "8", "--chain", "2"]) == 2
        assert trace.main(["--batch", "4", "--n", "8", "--chain", "2"]) == 2


def test_kkt_switch_passes_one_solver_to_every_solve():
    import torch.distributed as dist

    from conicip_tpu_torch import conic_ip, models, solver
    from conicip_tpu_torch.kkt import kktsolver_schur

    assert trace.parse_args([]).kkt == "auto"
    args = trace.parse_args(["--kkt", "tp", "--family", "rq_eq"])
    assert (args.kkt, args.family) == ("tp", "rq_eq")
    with pytest.raises(SystemExit):  # the TP solver takes one instance
        trace.parse_args(["--kkt", "tp", "--batch", "4"])
    # the reference's multichip problem: n = 512, m = 1088, p = 16
    P = trace.FAMILIES["rq_eq"](0, 0)
    assert (P.Q.shape, P.A.shape, P.G.shape) == ((512, 512), (1088, 512),
                                                  (16, 512))
    assert trace.kktsolver("auto", "float64", "cpu") is None
    assert trace.kktsolver("schur", "float64", "cpu") is kktsolver_schur
    assert trace.kktsolver("schur", "float32", "cpu").keywords == dict(
        factor_dtype=torch.float32)
    # tp: a world of one (gloo on the CPU) that stop_world ends; the one
    # solver takes the device loop, and a second solve hits its entry
    try:
        kkt = trace.kktsolver("tp", "float64", "cpu")
        box = models.box_qp_dense(n=12).args()
        for hit in (False, True):
            sol = conic_ip(*box, kktsolver=kkt, device="cpu")
            (run,) = solver.runs
            assert sol.status == "Optimal"
            assert (run.loop, run.cache_hit) == ("chunks", hit)
    finally:
        trace.stop_world()
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        assert trace.main(["--kkt", "tp", "--n", "8"]) == 2


def test_kkt_builds_count_each_loops_work():
    # the eager loop: the cold start's build and one per step, on either
    # variant; the device loop: one per unit (a poll after each, as after
    # the prologue), and a miss's prologue twice on the card
    from conicip_tpu_torch.solver import Run, ipm

    def run(loop, polls=0, hit=False, cold=1):
        return Run(None, "Optimal", 7, 7, 2, cold, 0, polls, 0, loop, 0, hit)

    assert trace.kkt_builds(run("eager")) == 1 + 7 + 2
    assert trace.kkt_builds(run("eager", cold=0)) == 9
    assert trace.kkt_builds(run("graph", polls=8, hit=True)) == 1 + 7 * ipm.POLL
    assert trace.kkt_builds(run("graph", polls=8)) == 2 + 7 * ipm.POLL
    assert trace.kkt_builds(run("chunks", polls=8)) == 1 + 7 * ipm.POLL
    assert trace.kkt_builds(run("graph", polls=8, cold=0)) == 7 * ipm.POLL
