"""The plain reference: the VAP model in float64 PyTorch, written from the
model's description (rvap/vap_main: encoder_components.py, modules.py,
objective.py; the realtime step's semantics) with no kernel, no cache
and no batching tricks.  It imports nothing of `vap_realtime_tpu_torch`
and nothing of JAX, and takes from a run only the weights and inputs the
benchmark made (never the port's packed weights or state).

- `serving.py`: a stream's outputs frame by frame, from its whole audio:
  one seamless conv stack, the LSTM from zero state, the downsample, and
  the trunk over all frames with each frame attending to the last T
  positions (itself included), which is what the port's ring cache with
  per-stream ages computes.
- `train.py`: the training forward with dropout, the loss, autograd and
  AdamW, for the first steps of a run.
"""
