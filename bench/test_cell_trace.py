"""The trace reader on a hand-made trace: kernel names as the profiler
writes them, steps between the benchmark's markers, the union of busy
intervals, launches by step."""
from benchlib import trace

FLASH = ("void (anonymous namespace)::flash_bwd_bf16<128>(CUtensorMap_st, "
         "(anonymous namespace)::BwdArgs)")
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctorOnSelf_add<float>, std::array<char*, 2ul> >"
       "(int, at::native::CUDAFunctorOnSelf_add<float>)")
POW = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "(anonymous namespace)::pow_tensor_scalar_kernel_impl<float, float>"
       "(at::TensorIteratorBase&, float)::{lambda(float)#1}>(int)")


def test_names():
    assert trace.kernel_name(FLASH) == "flash_bwd_bf16"
    assert trace.kernel_name(ADD) == "vectorized_elementwise_kernel"
    assert trace.op_name(ADD) == ("vectorized_elementwise_kernel"
                                  "<CUDAFunctorOnSelf_add>")
    assert trace.op_name(POW) == ("vectorized_elementwise_kernel"
                                  "<pow_tensor_scalar_kernel_impl>")
    assert trace.op_name(FLASH) == "flash_bwd_bf16"


def _marker(ts):
    return {"cat": "user_annotation", "name": trace.MARKER, "ts": ts,
            "dur": 1}


def _kernel(name, ts, dur, corr, launch_ts):
    return [{"cat": "kernel", "name": name, "ts": ts, "dur": dur,
             "args": {"correlation": corr}},
            {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch_ts, "dur": 2, "args": {"correlation": corr}}]


def test_window_steps_busy_and_launches():
    events = [_marker(0), _marker(100), _marker(200)]
    # step 0: two overlapping kernels; step 1: one kernel and a copy; a
    # kernel launched before the window is not the window's
    events += _kernel(FLASH, 10, 30, 1, 5) + _kernel(ADD, 30, 20, 2, 8)
    events += _kernel(ADD, 150, 10, 3, 120) + _kernel(ADD, -50, 10, 4, -60)
    events.append({"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 170,
                   "dur": 5, "args": {}})
    w = trace.Window(events)
    assert (w.steps, w.window_s) == (2, 200e-6)
    assert w.launches_by_step() == [2, 1]
    assert w.busy_intervals() == [(10, 50), (150, 160), (170, 175)]
    assert abs(w.busy_s - 55e-6) < 1e-12
    assert w.kernel_count(r"flash_bwd_") == 1
    assert abs(w.kernel_seconds(r"vectorized") - 30e-6) < 1e-12
