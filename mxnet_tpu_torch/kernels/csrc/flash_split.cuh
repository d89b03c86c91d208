// The split geometry of the flash-attention kernels, shared by the forward
// bodies (flash_fwd.cuh, flash_fwd_bf16.cuh, and the combine pass of
// flash_fwd_grid.cuh) and the backward bodies (flash_bwd.cuh,
// flash_bwd_bf16.cuh, and the reduce passes of flash_bwd_grid.cu).
//
// The grid kernels cut the walked axis into splits of w rows (a multiple
// of the 32-row split unit), one block per split, and a second pass merges
// or sums, for each row, the splits that row can see. A split no row of a
// block can see is dead: the block returns at once, loading and writing
// nothing, and the second pass never reads it. Both decisions come from
// the two functions below, so a read split is always a written one.
#pragma once
#include <cuda_runtime.h>

namespace mx_flash {
namespace {

// the lse of a row that sees no key, and a score no key has
constexpr float kNeg = -1e30f;

// Splits of width w whose first key a query row at global position q_pos
// can see: splits [0, result) are live for the row.
__device__ __forceinline__ int live_kv_splits(int q_pos, int k_base, int w,
                                              int n_split, int causal) {
  if (!causal) return n_split;
  const int rel = q_pos - k_base;
  if (rel < 0) return 0;
  return min(rel / w + 1, n_split);
}

// The first query split (width wq) holding a row that can see the key at
// global position k_pos: splits [result, n_split) are live for the key
// (n_split: none is).
__device__ __forceinline__ int first_live_q_split(int k_pos, int q_base,
                                                  int sq, int wq,
                                                  int n_split, int causal) {
  if (!causal) return 0;
  const int rel = k_pos - q_base;   // the first query row that sees it
  if (rel <= 0) return 0;
  if (rel > sq - 1) return n_split;
  return rel / wq;
}

}  // namespace
}  // namespace mx_flash
