"""output_tok_s: every output token emitted in the window over the
window's seconds."""


def read(run):
    return run.output_tokens / run.seconds
