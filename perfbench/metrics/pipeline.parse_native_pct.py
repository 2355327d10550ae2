"""Share of the window's FASTQ chunks that the host library parsed:
`MapStats.parse_native_chunks` over `MapStats.parse_chunks` (the
reader's chunks; the rest went through numpy's fallback parse). A
program without these counters reports nothing."""


def read(ctx):
    chunks = ctx["stats"].get("parse_chunks")
    native = ctx["stats"].get("parse_native_chunks")
    if not chunks or native is None:
        return None
    return 100.0 * native / chunks
