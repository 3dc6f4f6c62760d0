// The d = 24 and d = 32 instances of sampler_adj.cu's kernels and their C
// entries (named with the suffix _wide; estep_common.cuh's SVAE_WIDE): a
// source of their own, so that the build compiles them in parallel with the
// instances up to 16.
#define SVAE_WIDE
#include "sampler_adj.cu"
