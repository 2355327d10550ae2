"""Seconds to load the program's index (`load_index`; on a checkout's
first run, its build and save first), by the harness's clock."""


def read(ctx):
    return ctx["index_load_s"]
