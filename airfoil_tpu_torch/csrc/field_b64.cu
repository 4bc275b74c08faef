// Base64 of a served frame's fields for Hopper (sm_90a), every requested
// field in one launch; plain C interface.
//
// Replaces no TPU kernel: the JAX package encodes each field on the host
// (airfoil_tpu/api/handlers.py::_b64_field, base64.b64encode of the host
// copy). The plain version is binascii.b2a_base64(buf, newline=False) on
// the host, and the Python wrapper is
// airfoil_tpu_torch/api/field_b64.py::b64encode, which takes that plain
// version for CPU tensors and this kernel for CUDA tensors, so that the
// host copies ASCII once into pinned memory instead of copying each field
// through pageable staging and encoding it on one core.
//
// Output. Field k (up to kMaxFields) of bytes[k] bytes is written as the
// standard base64 string (alphabet A-Za-z0-9+/, '=' padding, no line
// breaks) of 4 * ceil(bytes[k] / 3) bytes at dst + out[k]; each field is
// its own string with its own padding. Every out[k] is 16 B aligned (the
// launch refuses one that is not); the bytes between two strings are never
// written or read.
//
// Design. The kernel is bound by bytes moved: it reads each input byte once
// and writes 4/3 of a byte. One thread takes a group of 12 input bytes
// (three 32-bit loads: every field starts on a 4 B boundary, as a float32
// tensor does, and the launch refuses one that does not) and writes its 16
// characters with one 16-byte store, so a warp stores 512 contiguous
// bytes. The groups of all fields form one index
// space (field k's groups end at group_end[k]), walked by a grid-stride
// loop; a field's last group, short by 1-11 bytes, is encoded by a scalar
// tail with its padding. The alphabet is arithmetic on four 6-bit indices
// packed in a word (no table, no divergent lookups): each index x maps to
// x + 'A', plus 6 from 26 on, less 75 from 52 on, less 15 from 62 on, plus
// 3 at 63, each comparison read from bit 7 of x + (128 - threshold).
//
// Bound. n bytes read and 4 * ceil(n / 3) written, over 3.35 TB/s: 5.9 us
// for one 2048x1024 float32 field (8,388,608 B), 0.6 us for three 384x192
// fields (3 x 294,912 B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 5;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;   // 8 resident blocks of 256 on 132 SMs, twice

struct Fields {
  const uint8_t* src[kMaxFields];
  unsigned long long bytes[kMaxFields];
  unsigned long long out[kMaxFields];
  unsigned int group_end[kMaxFields];  // cumulative 12-byte groups
  int count;
};

// Four 6-bit indices, one a byte (index 0 in the low byte), to their four
// base64 characters.
__device__ __forceinline__ uint32_t b64_chars(uint32_t x) {
  const uint32_t ge26 = ((x + 0x66666666u) >> 7) & 0x01010101u;
  const uint32_t ge52 = ((x + 0x4c4c4c4cu) >> 7) & 0x01010101u;
  const uint32_t ge62 = ((x + 0x42424242u) >> 7) & 0x01010101u;
  const uint32_t ge63 = ((x + 0x41414141u) >> 7) & 0x01010101u;
  return x + 0x41414141u + ge26 * 6u - ge52 * 75u - ge62 * 15u + ge63 * 3u;
}

// The three bytes b0 b1 b2 held as (b0 << 16) | (b1 << 8) | b2 (bits 24-31
// ignored) to their four characters, the first in the low byte.
__device__ __forceinline__ uint32_t b64_triplet(uint32_t v) {
  return b64_chars(((v >> 18) & 0x3fu) | ((v >> 4) & 0x3f00u) |
                   ((v << 10) & 0x3f0000u) | ((v << 24) & 0x3f000000u));
}

// The last 1-11 bytes of a field and their padding, 4 characters at a time.
__device__ void b64_tail(const uint8_t* s, int left, uint32_t* d) {
  for (int k = 0; 3 * k < left; ++k) {
    const int m = min(3, left - 3 * k);
    const uint8_t* p = s + 3 * k;
    const uint32_t v = (uint32_t(p[0]) << 16) |
                       (m > 1 ? uint32_t(p[1]) << 8 : 0u) |
                       (m > 2 ? uint32_t(p[2]) : 0u);
    uint32_t c = b64_triplet(v);
    if (m < 3) c = (c & 0x00ffffffu) | 0x3d000000u;  // '='
    if (m < 2) c = (c & 0x0000ffffu) | 0x3d3d0000u;
    d[k] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
field_b64_kernel(const Fields f, uint8_t* __restrict__ dst) {
  const unsigned int total = f.group_end[f.count - 1];
  for (unsigned int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    // The group's field, by static indices only (no local copy of `f`).
    const uint8_t* src = f.src[0];
    unsigned long long bytes = f.bytes[0], out = f.out[0];
    unsigned int first = 0;
#pragma unroll
    for (int k = 1; k < kMaxFields; ++k) {
      if (k < f.count && i >= f.group_end[k - 1]) {
        src = f.src[k];
        bytes = f.bytes[k];
        out = f.out[k];
        first = f.group_end[k - 1];
      }
    }
    const unsigned long long g = i - first;
    const uint8_t* s = src + 12ull * g;
    uint8_t* d = dst + out + 16ull * g;
    const unsigned long long left = bytes - 12ull * g;
    if (left < 12) {
      b64_tail(s, int(left), reinterpret_cast<uint32_t*>(d));
      continue;
    }
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    uint4 c;
    c.x = b64_triplet(__byte_perm(w0, 0u, 0x0012));   // bytes 0 1 2
    c.y = b64_triplet(__byte_perm(w0, w1, 0x0345));   // bytes 3 4 5
    c.z = b64_triplet(__byte_perm(w1, w2, 0x0234));   // bytes 6 7 8
    c.w = b64_triplet(__byte_perm(w2, 0u, 0x0123));   // bytes 9 10 11
    *reinterpret_cast<uint4*>(d) = c;
  }
}

}  // namespace

extern "C" {

// Base64 of `count` (1..5) device buffers, src[k] of bytes[k] bytes (src[k]
// 4 B aligned), each into dst + out[k] (16 B aligned), in one launch on
// `stream`.
// `src`, `bytes` and `out` are host arrays; `src` and `dst` hold device
// pointers. Allocates nothing and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success), or an error without
// launching for a count, an offset or a size it does not take.
int field_b64_launch(const void* const* src, const long long* bytes,
                     const long long* out, int count, void* dst, int device,
                     void* stream) {
  if (count < 1 || count > kMaxFields) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Fields f = {};
  unsigned long long groups = 0;
  for (int k = 0; k < count; ++k) {
    if (bytes[k] < 0 || out[k] < 0) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(dst) + out[k]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(src[k]) % 4 != 0)
      return cudaErrorMisalignedAddress;
    f.src[k] = static_cast<const uint8_t*>(src[k]);
    f.bytes[k] = bytes[k];
    f.out[k] = out[k];
    groups += (bytes[k] + 11) / 12;
    if (groups >= (1ull << 31)) return cudaErrorInvalidValue;
    f.group_end[k] = static_cast<unsigned int>(groups);
  }
  f.count = count;
  if (groups == 0) return cudaSuccess;
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  const int blocks = want < kMaxBlocks ? int(want) : kMaxBlocks;
  field_b64_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<uint8_t*>(dst));
  return cudaGetLastError();
}

const char* field_b64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
