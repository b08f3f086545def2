// The attention dropout bits: the one definition, included by
// fused_attention.cu (fp32 kernels) and fused_attention_sm90.cu (bf16
// kernels), mirrored bit for bit by the plain PyTorch version
// (ops/fused_attention.py::dropout_bits). The bits of element idx = i*T + j
// (query i, key j) of head bh = b*H + h are
//     dropout_bits(dropout_stream(seed, bh), idx)
// and the element is kept when they are >= threshold.
#pragma once

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr unsigned DROPOUT_IDX_MUL = 0x9E3779B1u;

// per (seed, b*H + h) stream key
__device__ __forceinline__ unsigned dropout_stream(unsigned seed, unsigned bh) {
  return fmix32(seed ^ fmix32(bh + 0x9E3779B9u));
}

// bits of element idx = i*T + j of that stream
__device__ __forceinline__ unsigned dropout_bits(unsigned stream, unsigned idx) {
  return fmix32(stream ^ (idx * DROPOUT_IDX_MUL));
}
