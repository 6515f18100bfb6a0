"""loop.in_flight_share: the time-averaged number of requests at the
server over the window, as a share of the cell's concurrency: how much of
the offered load the closed loop kept in flight (Little's law over the
request log)."""


def read(rec: dict):
    return 100.0 * rec["in_flight_mean"] / rec["concurrency"]
