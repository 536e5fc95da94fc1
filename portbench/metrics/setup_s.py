"""setup_s: seconds from the start of the process to the first timed frame
or step: imports, the scene written and parsed, the program's build (nvcc
and g++ on a checkout's first run), capture, warm-up; for training also the
target and the first steps that the check reads."""


def read(ctx):
    return ctx.get("setup_s")
