"""openekfmonoslam_tpu_torch: the PyTorch / CUDA port of openekfmonoslam_tpu.

Every module mirrors the JAX package's module at the same relative path
(``filter/update.py`` here is the port of ``openekfmonoslam_tpu/filter/
update.py``) and is held against it by ``tests/test_torch_*.py``.  Plain
tensor code is PyTorch; each Pallas TPU kernel on the ported path has a
hand-written CUDA kernel for Hopper (``csrc/*.cu``, wrapped by
``ops/*_kernel.py``) with its plain PyTorch version beside it.

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``openekfmonoslam_tpu``.  Entry points run on the first CUDA device unless
the caller passes ``device="cpu"``.

Ported so far:
  * the engine API: ``engine.engine.SlamEngine`` and ``run_sequence``,
    ``engine.checkpoint`` (files in the JAX layout) and the CLI,
    ``python -m openekfmonoslam_tpu_torch.cli``;
  * the live path: ``SlamRuntime.init_step`` and ``SlamRuntime.step`` with
    every detector (FAST, the default; STAR, the s3 profile's; ORB, SIFT,
    SURF, HARRIS, SHI_TOMASI) and every descriptor (BRIEF, ORB, SURF /
    SIFT floats) but the PATCH descriptor of the NCC matcher, and
    ``engine.scan_runner`` (``scan_frames``, ``run_sequence_on_device``);
    ``eval.replay.record_live_log`` records its injection log;
  * the filter replay path: ``SlamRuntime.step_injected``,
    ``io.handmatching.replay``, ``eval.replay.replay_through_engine``.
"""

__version__ = "0.1.0"

from openekfmonoslam_tpu_torch.config import (  # noqa: F401
    CameraCalibration,
    EKFParams,
    SlamConfig,
    load_config,
)
