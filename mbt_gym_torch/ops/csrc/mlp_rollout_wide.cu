// K3's wide route (bf16 trunks past 256 rows) as a library of its own:
// mlp_rollout.cu with MBT_K3_WIDE set, which instantiates
// mlp_rollout_wide_kernel alone (see mlp_rollout.cu's header), so that the
// two libraries compile side by side.  ops/mlp_rollout.py loads this one
// for a bf16 trunk that takes K3's scratch, the other for every other call.
#define MBT_K3_WIDE 1
#include "mlp_rollout.cu"
