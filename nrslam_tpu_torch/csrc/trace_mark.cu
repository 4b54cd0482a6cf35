// The stage stamps of a captured frame (nrslam_tpu_torch/utils/profiler.py
// ::Stamps): a one-thread mark that writes the device's global nanosecond
// timer into a slot of a small int64 buffer, and the node count of the
// graph a stream is capturing, read at each mark while the frame is
// captured.

#include <cuda_runtime.h>

namespace nrslam {

__global__ void trace_mark_kernel(long long* slot) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace nrslam

// The timer into *slot, on the stream (captured where the stream captures).
extern "C" int nrslam_trace_mark(void* slot, void* stream) {
  nrslam::trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}

// *out = the nodes of the graph the stream is capturing, -1 where it
// captures none.
extern "C" int nrslam_capture_nodes(void* stream, long* out) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) {
    *out = -1;
    return 0;
  }
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *out = static_cast<long>(n);
  return static_cast<int>(err);
}
