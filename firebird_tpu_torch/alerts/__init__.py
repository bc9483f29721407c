"""Change alerting: the durable alert log (``alerts.log``) the stream
driver appends confirmed breaks to; the feed that delivers it by cursor
pull, SSE push and webhooks (``alerts.feed``); the fanout plane that
shards delivery over the quadkey subscription index into idempotent fleet
jobs (``alerts.subindex``, ``alerts.fanout``); and the cold-path repair of
broken pixels (``alerts.repair``).  Delivery is host code: nothing here
but the repair touches the card."""

from firebird_tpu_torch.alerts.fanout import (FanoutCoordinator,
                                              FanoutDeliverer, rollup)
from firebird_tpu_torch.alerts.feed import AlertFeed, WebhookDeliverer
from firebird_tpu_torch.alerts.log import AlertLog, alert_db_path
from firebird_tpu_torch.alerts.repair import repair_chip, schedule_repairs

__all__ = [
    "AlertFeed",
    "AlertLog",
    "FanoutCoordinator",
    "FanoutDeliverer",
    "WebhookDeliverer",
    "alert_db_path",
    "repair_chip",
    "rollup",
    "schedule_repairs",
]
