"""Hand-written CUDA kernels for Hopper (sm_90a), each with a plain PyTorch
version in ref.py and a dispatching wrapper in ops.py.

  gossip_mix   -- kernel K1, the weighted gossip mix on a stacked state
                  (replaces the Pallas `gossip_mix_weighted` and its gather)
                  and K3, the flat per-node mix with scalar weights
                  (replaces the Pallas `gossip_mix` and its padding)
  compress_mix -- kernel K2, the same mix over sparsified messages
                  (replaces the Pallas `compress_mix_weighted` and its
                  two gathers)
  flash_attention -- kernel K4, attention forward with GQA and a top-left
                  causal mask (replaces the Pallas `flash_attention`)
  ssd_scan     -- kernel K5, the Mamba-2 SSD scan in its chunked form
                  (replaces the Pallas `ssd_scan`)
  selective_scan -- kernel K6, the Mamba-1 selective scan (replaces the
                  Pallas `selective_scan`)

`ops` holds the front doors, one per front door of `repro.kernels.ops`.

Sources live in csrc/ and are built at first use by build.py.
"""

from repro_torch.kernels import ops, ref
