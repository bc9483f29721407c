"""Change alerting's producer side: the durable alert log
(``alerts.log``) the stream driver appends confirmed breaks to, and the
cold-path repair of broken pixels (``alerts.repair``).  The feed, the
webhooks and the fanout plane are not ported yet."""

from firebird_tpu_torch.alerts.log import AlertLog, alert_db_path
from firebird_tpu_torch.alerts.repair import repair_chip, schedule_repairs

__all__ = ["AlertLog", "alert_db_path", "repair_chip", "schedule_repairs"]
