"""infer_per_s: requests completed without error in the window, over the
window's seconds."""


def read(rec: dict):
    w = rec["window"]
    done = sum(1 for _, d, ok in rec["requests"]
               if ok and w["t0"] <= d < w["t1"])
    return done / w["seconds"]
