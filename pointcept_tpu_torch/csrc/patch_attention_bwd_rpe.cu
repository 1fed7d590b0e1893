// The score-biased (RPE) instances of the patch-attention backward, with the
// table's gradient: the kernels of patch_attention_bwd.cu with the bias on
// (see that file), built as a library of their own so that nvcc compiles
// the two halves in parallel.
#define PATCH_ATTENTION_RPE 1
#include "patch_attention_bwd.cu"
