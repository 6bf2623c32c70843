"""The whole step's share of the card's peak (%): the model's operations
in the window's steps (every sparse conv, 2 M Cin Cout for the forward and
as many again for the dX, but conv1's, and for the dW, M the matched
pairs of the reference's maps at the step's inputs) over the window times
the configuration's peak."""


def read(ctx, record):
    work, w = record.get("work"), record.get("window")
    if not work or not w:
        return None
    flops = work["model_flops"] * w["steps"]
    return 100.0 * flops / (w["seconds"] * work["peak_flops"])
