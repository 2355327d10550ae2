"""Faults planted under a CPU rehearsal of a run, each of which the
check has to catch: each is given the program's pipeline as it is built
(rehearse.py)."""


def _wrap_decode(pipe, change):
    decode = pipe.device.decode_out

    def decode_out(vec):
        return change(decode(vec))
    pipe.device.decode_out = decode_out


def half_batch_left_out(pipe):
    """The step's answers for the second half of every batch dropped."""
    half = pipe.batch_size // 2

    def change(out):
        keep = out["lane_read"] < half
        for k in ("lane_read", "lane_rc", "lane_bucket", "offset", "votes"):
            out[k] = out[k][keep]
        return out
    _wrap_decode(pipe, change)


def answer_altered(pipe):
    """Every voted offset one base off where the step produces it."""
    def change(out):
        out["offset"] = out["offset"] + 1
        return out
    _wrap_decode(pipe, change)


FAULTS = {"half_batch_left_out": half_batch_left_out,
          "answer_altered": answer_altered}
