"""Core: the paper's contribution -- consensus-based distributed optimization
with explicit communication/computation tradeoff control (PyTorch port)."""

from repro_torch.core.graphs import (CommGraph, GraphSequence, build_graph,
                                     complete_graph, expander_sequence,
                                     hypercube_graph, kregular_expander,
                                     lambda2, random_regular_expander,
                                     ring_graph, spectral_gap, torus_graph)
from repro_torch.core.schedules import (CommSchedule, EveryIteration,
                                        IncreasinglySparse, Periodic,
                                        PiecewisePeriodic, c1_constant,
                                        ch_constant, cp_constant,
                                        make_schedule, optimal_stepsize_A)
from repro_torch.core.tradeoff import (H100_SXM, HardwareSpec,
                                       derive_r_from_roofline, ew_alpha,
                                       ew_update, h_opt, h_opt_int,
                                       iteration_cost, lambda2_fast,
                                       measure_r, n_opt_complete,
                                       predict_speedup, time_to_accuracy)
from repro_torch.core.consensus import (disagreement, mix_collective,
                                        mix_dense, mix_stale, stale_combine,
                                        stale_combine_batch,
                                        tree_mix_collective, tree_mix_dense)
from repro_torch.core.dda import (DDASimulator, DDAState, SimTrace, dda_init,
                                  dda_local_step, dda_mix_step,
                                  stepsize_sqrt)
from repro_torch.core.compression import (CompressionState, ef_compress,
                                          ef_init, ratio_bytes, topk_compress,
                                          topk_decompress)
from repro_torch.core.consensus_sgd import (ConsensusConfig, mix_params,
                                            mix_params_dense)
