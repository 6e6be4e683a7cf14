"""Hand-written CUDA kernels for Hopper (sm_90a), each with a plain PyTorch
version in ref.py and a dispatching wrapper in ops.py.

  gossip_mix   -- kernel K1, the weighted gossip mix on a stacked state
                  (replaces the Pallas `gossip_mix_weighted` and its gather)
  compress_mix -- kernel K2, the same mix over sparsified messages
                  (replaces the Pallas `compress_mix_weighted` and its
                  two gathers)

Sources live in csrc/ and are built at first use by build.py.
"""

from repro_torch.kernels import ops, ref
