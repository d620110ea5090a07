"""Reading a trace: the program's kernels by name from its sources, the
device busy time, and the idle gaps named by the host."""

from conftest import BENCH

from harness import trace

CSRC = BENCH.parent / "smoothmesh_torch" / "csrc"


def test_program_kernels_are_found_in_the_sources():
    names = trace.program_kernel_names(CSRC)
    assert {"face_geometry_kernel", "cell_centres_kernel",
            "predictor_kernel", "freeze_kernel", "face_angles_kernel",
            "point_face_angles_kernel", "raycast_kernel",
            "table_gather_kernel"} <= names


def test_kernel_id_strips_signature_and_namespaces():
    for raw, want in [
            ("void (anonymous namespace)::freeze_kernel(float const*, int)",
             "freeze_kernel"),
            ("void at::native::elementwise_kernel<128, 2>(int, F)",
             "elementwise_kernel"),
            ("raycast_kernel(float const*)", "raycast_kernel")]:
        assert trace.kernel_id(raw) == want


def test_summarize_busy_and_gaps():
    ev = [dict(ph="X", cat="kernel", name="void a_kernel(int)", ts=0,
               dur=10),
          dict(ph="X", cat="kernel", name="b_kernel(int)", ts=5, dur=10),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=40, dur=5),
          dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=14,
               dur=20)]
    s = trace.summarize(ev)
    want = {"a_kernel": 10e-6, "b_kernel": 10e-6, "gpu_memcpy": 5e-6}
    assert s["by_op"].keys() == want.keys()
    assert all(abs(s["by_op"][k] - v) < 1e-15 for k, v in want.items())
    assert abs(s["busy_s"] - 20e-6) < 1e-12
    assert [g[0] for g in s["gaps"]] == ["cudaMemcpyAsync"]
    assert abs(s["gaps"][0][1] - 25e-6) < 1e-15
