"""optimizer_ms.train: the card's busy ms inside the program's
``repro_torch.train.optimizer`` span (AdamW's norm, clip and update,
entered once the loss read has drained the card and left after a sync),
over the traced steps that updated."""
from cardbench import spans


def read(ctx):
    return spans.mean_busy_ms(ctx["trace"], "repro_torch.train.optimizer")
