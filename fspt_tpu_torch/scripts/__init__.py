"""The round-5 traversal studies of scripts/, ported: the same measurement
entry points (module names mirror scripts/), each kernel hand-written in
CUDA under csrc/ with its plain PyTorch version beside it.

  r5common          the captured bounce-0 launch and timing helpers;
  traverse5_proto   packet_traverse5, the mixed-substep walk (csrc/walk5.cu);
  perf_r5i          v4 against v5 on the captured launch;
  perf_r5_treelet   the two-level TLAS + dense-MT study (csrc/dense_mt.cu);
  perf_r5d          the fixed-iteration substep micro (csrc/micro.cu).

Run a study on the card as `python -m fspt_tpu_torch.scripts.perf_r5i`
(likewise perf_r5_treelet, perf_r5d).
"""
