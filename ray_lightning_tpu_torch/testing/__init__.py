"""Testing utilities (copied from ``ray_lightning_tpu/testing/``):
in-process fakes of the Ray substrate, for launcher tests without Ray,
and the determinism check (:func:`assert_deterministic`)."""
from ray_lightning_tpu_torch.testing.determinism import (assert_deterministic,
                                                         fit_fingerprint)
from ray_lightning_tpu_torch.testing.fake_ray import (FakeQueueHandle,
                                                      FakeRay,
                                                      RecordingExecutor,
                                                      ThreadedFakeRay)

__all__ = ["FakeQueueHandle", "FakeRay", "RecordingExecutor",
           "ThreadedFakeRay", "assert_deterministic", "fit_fingerprint"]
