"""setup_s: seconds from the process's start to the first timed request
(loading, weights, warm-up, graph captures and the loop's warm period)."""


def read(rec: dict):
    return rec["setup_s"]
