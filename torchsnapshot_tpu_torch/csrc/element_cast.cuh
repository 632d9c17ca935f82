// Element conversion shared by the slab unpack (K2) and tile update (K6)
// kernels: one element of a stored dtype, read at any byte alignment,
// converted to the restore template's dtype and stored.
//
// Float casts go through float (and double for f64) exactly as torch's
// own copy kernel does, so a converted element equals ``tensor.to(dtype)``
// bit for bit; integer casts go through a 64-bit integer with C's
// wrap-around, as torch's do.  The codes are the Python wrappers'
// (``_CODES`` in ops/device_pack.py); code 0 means raw bytes (identity).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <cstring>

enum Code : int {
  kBytes = 0,  // identity: copy ``n`` raw bytes
  kF16 = 1, kBF16 = 2, kF32 = 3, kF64 = 4,
  kI8 = 5, kI16 = 6, kI32 = 7, kI64 = 8,
  kU8 = 9, kU16 = 10, kU32 = 11, kU64 = 12,
};

__host__ __device__ __forceinline__ int code_size(int code) {
  switch (code) {
    case kI8: case kU8: return 1;
    case kF16: case kBF16: case kI16: case kU16: return 2;
    case kF32: case kI32: case kU32: return 4;
    default: return 8;
  }
}

template <typename T>
__device__ __forceinline__ T load(const uint8_t* p, long long i, bool aligned) {
  if (aligned) return reinterpret_cast<const T*>(p)[i];
  T v;
  memcpy(&v, p + i * static_cast<long long>(sizeof(T)), sizeof(T));
  return v;
}

__device__ __forceinline__ bool is_float(int code) { return code >= kF16 && code <= kF64; }

__device__ __forceinline__ double load_float(const uint8_t* p, int code, long long i,
                                             bool al) {
  switch (code) {
    case kF16: return __half2float(__ushort_as_half(load<unsigned short>(p, i, al)));
    case kBF16:
      return __bfloat162float(__ushort_as_bfloat16(load<unsigned short>(p, i, al)));
    case kF32: return load<float>(p, i, al);
    default: return load<double>(p, i, al);
  }
}

__device__ __forceinline__ void store_float(long long dst, int code, long long i,
                                            double x) {
  switch (code) {
    case kF16:
      reinterpret_cast<__half*>(dst)[i] = __float2half_rn(static_cast<float>(x));
      break;
    case kBF16:
      reinterpret_cast<__nv_bfloat16*>(dst)[i] =
          __float2bfloat16_rn(static_cast<float>(x));
      break;
    case kF32: reinterpret_cast<float*>(dst)[i] = static_cast<float>(x); break;
    default: reinterpret_cast<double*>(dst)[i] = x; break;
  }
}

__device__ __forceinline__ long long load_int(const uint8_t* p, int code, long long i,
                                              bool al) {
  switch (code) {
    case kI8: return load<signed char>(p, i, al);
    case kI16: return load<short>(p, i, al);
    case kI32: return load<int>(p, i, al);
    case kI64: return load<long long>(p, i, al);
    case kU8: return load<unsigned char>(p, i, al);
    case kU16: return load<unsigned short>(p, i, al);
    case kU32: return load<unsigned int>(p, i, al);
    default: return static_cast<long long>(load<unsigned long long>(p, i, al));
  }
}

__device__ __forceinline__ void store_int(long long dst, int code, long long i,
                                          long long x) {
  switch (code) {
    case kI8: reinterpret_cast<signed char*>(dst)[i] = static_cast<signed char>(x); break;
    case kI16: reinterpret_cast<short*>(dst)[i] = static_cast<short>(x); break;
    case kI32: reinterpret_cast<int*>(dst)[i] = static_cast<int>(x); break;
    case kI64: reinterpret_cast<long long*>(dst)[i] = x; break;
    case kU8: reinterpret_cast<unsigned char*>(dst)[i] = static_cast<unsigned char>(x); break;
    case kU16:
      reinterpret_cast<unsigned short*>(dst)[i] = static_cast<unsigned short>(x);
      break;
    case kU32:
      reinterpret_cast<unsigned int*>(dst)[i] = static_cast<unsigned int>(x);
      break;
    default:
      reinterpret_cast<unsigned long long*>(dst)[i] = static_cast<unsigned long long>(x);
      break;
  }
}
