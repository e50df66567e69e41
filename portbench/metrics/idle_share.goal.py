"""Share of the traced window in which no device operation ran: 1 - the
union of the operations' intervals over the window's own wall time
(``idle.idle_share_percent``; one metric per end-to-end metric it moves)."""
from portbench.idle import idle_share_percent as read  # noqa: F401
