// The score-biased (RPE) instances of the patch-attention forward: the
// kernel of patch_attention.cu with its bias on (PT-v3m1's relative
// position encoding; see that file), built as a library of its own so that
// nvcc compiles the two halves in parallel.
#define PATCH_ATTENTION_RPE 1
#include "patch_attention.cu"
