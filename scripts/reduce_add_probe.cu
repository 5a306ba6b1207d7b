// Throughput of fp32 adds into global memory from a block's shared memory or
// from registers, in the pattern of attn_bwd_wide_kernel's dQ adds
// (csrc/flash_attention_bwd.cu): each step a block adds a 64 x 192 fp32 tile
// (48 KB) of a (rows, 192) accumulator; 8 warps, warp w holds rows 16 (w % 4)
// .. + 15, columns 96 (w / 4) .. + 95.  132 blocks of 256 threads, 2,000
// steps; each block cycles over its own `tiles` tiles (argv[1], default 16:
// 101 MB in all, past the 50 MB L2; 1, 2, 4 stay in it).  Modes: 1-d bulk
// reduce-adds of 384-byte rows from 16 lanes a warp, 16-byte REDs from
// registers, 16-byte stores from registers, 1-d bulk stores of the rows,
// and bulk tensor reduce-adds of (32 columns x 16 rows) boxes in the map's
// 128-byte swizzle, 3 a warp.  Prints one JSON line a mode and run; built
// and run by scripts/reduce_add_probe.py.
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
#include <cuda.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__global__ void __launch_bounds__(256, 1) probe(const __grid_constant__ CUtensorMap map, float* acc, int tiles_per_block, int steps, int mode, int rows_per_lane) {
  extern __shared__ __align__(1024) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int SP = 104;
  for (int i = tid; i < 2 * 64 * SP; i += 256) sm[i] = 1.0f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float* wst = sm + (warp / 4) * 64 * SP;
  const int r0 = 16 * (warp % 4);
  const long long region = (long long)blockIdx.x * tiles_per_block * 64 * 192;
  float v[48];
  for (int j = 0; j < 48; ++j) v[j] = 1.0f;
  for (int s = 0; s < steps; ++s) {
    float* tile = acc + region + (long long)(s % tiles_per_block) * 64 * 192 + 96 * (warp / 4);
    if (mode == 0 || mode == 3) {
      if (lane < 16) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      if (lane < 16) {
        float* dst = tile + (long long)(r0 + lane) * 192;
        const float* src = wst + (r0 + lane) * SP;
        if (mode == 0)
          asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(384) : "memory");
        else
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(384) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else if (mode == 1) {  // 16-byte REDs from registers: rows row, row + 8 of the warp, 48 values a thread
      const int row = r0 + lane / 4;
      for (int j = 0; j < 12; ++j) {
        float* p = tile + (long long)(row + 8 * (j & 1)) * 192 + 16 * (j / 2) + 4 * (lane % 4);
        asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(v[4 * j]), "f"(v[4 * j + 1]), "f"(v[4 * j + 2]), "f"(v[4 * j + 3]) : "memory");
      }
    } else if (mode == 4) {  // tensor reduce-adds: 3 boxes of (32 columns, 16 rows) a warp, 128-byte swizzle
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        const int row0 = (blockIdx.x * tiles_per_block + s % tiles_per_block) * 64 + r0;
        for (int x = 0; x < 3; ++x) {
          const float* src = sm + warp * 1536 + x * 512;
          asm volatile("cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n"
                       ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(src)), "r"(96 * (warp / 4) + 32 * x), "r"(row0) : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else if (mode == 2) {  // plain 16-byte stores from registers
      const int row = r0 + lane / 4;
      for (int j = 0; j < 12; ++j) {
        float4* p = reinterpret_cast<float4*>(tile + (long long)(row + 8 * (j & 1)) * 192 + 16 * (j / 2) + 4 * (lane % 4));
        *p = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    }
  }
  if (lane < 16) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int main(int argc, char** argv) {
  const int blocks = 132, tiles = argc > 1 ? atoi(argv[1]) : 16, steps = 2000;
  const size_t n = (size_t)blocks * tiles * 64 * 192;
  float* acc;
  cudaMalloc(&acc, n * 4);
  cudaMemset(acc, 0, n * 4);
  const int smem = 2 * 64 * 104 * 4;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const char* names[] = {"bulk_reduce_add_f32_rows", "red_v4_registers", "st_v4_registers", "bulk_store_rows", "tensor_reduce_add_boxes"};
  typedef CUresult (*Enc)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*,
                          const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  void* fp = nullptr;
  cudaDriverEntryPointQueryResult q;
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fp, cudaEnableDefault, &q);
  CUtensorMap map;
  const cuuint64_t dims[2] = {192, (cuuint64_t)blocks * tiles * 64};
  const cuuint64_t strides[1] = {192 * 4};
  const cuuint32_t box[2] = {32, 16}, unit[2] = {1, 1};
  CUresult r = ((Enc)fp)(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, acc, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  printf("{\"encode\": %d}\n", (int)r);
  for (int rep = 0; rep < 2; ++rep)
    for (int mode = 0; mode < 5; ++mode) {
      cudaEvent_t a, b;
      cudaEventCreate(&a); cudaEventCreate(&b);
      probe<<<blocks, 256, smem>>>(map, acc, tiles, 50, mode, 1);
      cudaEventRecord(a);
      probe<<<blocks, 256, smem>>>(map, acc, tiles, steps, mode, 1);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const double bytes = (double)blocks * steps * 48 * 1024;
      printf("{\"mode\": \"%s\", \"ms\": %.4f, \"GB\": %.3f, \"TB_per_s\": %.4f, \"us_per_step\": %.4f, \"err\": \"%s\"}\n", names[mode], ms, bytes / 1e9, bytes / ms / 1e9, 1e3 * ms / steps, cudaGetErrorString(cudaGetLastError()));
    }
  return 0;
}
