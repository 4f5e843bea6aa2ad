"""In-process fakes of the Ray substrate, for launcher tests without Ray
(copied from ``ray_lightning_tpu/testing/``; the determinism helpers wait
for ``ROADMAP.md`` A9)."""
from ray_lightning_tpu_torch.testing.fake_ray import (FakeQueueHandle,
                                                      FakeRay,
                                                      RecordingExecutor,
                                                      ThreadedFakeRay)

__all__ = ["FakeQueueHandle", "FakeRay", "RecordingExecutor",
           "ThreadedFakeRay"]
