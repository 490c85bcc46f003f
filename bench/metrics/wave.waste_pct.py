"""The share of the wave engine's token rows that served no request:
over its ``wave.prefill`` spans that started in the window, rows x the
padded width less the real prompt tokens (left padding and filler
rows), and over its ``wave.decode_step`` spans the rows less those still
serving a request; over every row computed (rows x width a prefill, rows
a decode step).  None where the program has no such span."""


def read(ctx):
    pre = [s.attrs for s in ctx.spans if s.name == "wave.prefill"]
    dec = [s.attrs for s in ctx.spans if s.name == "wave.decode_step"]
    rows = sum(a["rows"] * a["width"] for a in pre) + sum(a["rows"] for a in dec)
    if rows <= 0:
        return None
    waste = (sum(a["rows"] * a["width"] - a["real"] for a in pre)
             + sum(a["rows"] - a["live"] for a in dec))
    return 100.0 * waste / rows
