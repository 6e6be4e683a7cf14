"""repro_torch: the PyTorch/CUDA port of `repro`, for NVIDIA Hopper cards.

The layout follows `repro` module for module; each module here is tested
against its counterpart there (tests/test_torch_*.py). This package imports
`torch` and numpy, never `jax` and nothing of `repro`.

Device rule: every entry point takes `device=None`, which means the CUDA
card. Without a card it raises; only an explicit `device="cpu"` runs on the
CPU (the tests do). The experiment API is re-exported lazily (PEP 562), as
`repro` does, so `import repro_torch` stays cheap.
"""

_EXPERIMENT_API = (
    "ComponentSpec",
    "ExperimentSpec",
    "RunResult",
    "run",
    "run_all",
    "run_sweep",
)

__all__ = list(_EXPERIMENT_API) + ["resolve_device"]


def resolve_device(device=None):
    """The `torch.device` an entry point runs on.

    `None` means `"cuda"`. A CUDA device raises `RuntimeError` when no card
    is present: the port never moves to the CPU by itself. Only an explicit
    `"cpu"` (or `torch.device("cpu")`) runs on the CPU.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_device_or_meta(device=None):
    """`resolve_device`, with the meta device let through: the dry-run
    builds trees of shapes and dtypes on it (`launch/specs.py`)."""
    import torch

    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def __getattr__(name):
    if name in _EXPERIMENT_API:
        from repro_torch import experiments
        return getattr(experiments, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
