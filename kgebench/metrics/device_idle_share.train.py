"""Device: the share of the profiled window with no device activity (%)."""
from kgebench.yardstick.readers import idle_share as read  # noqa: F401
