"""rtfx: audio seconds of every batch completed in the window over the
window's wall time; the window runs whole batches."""


def read(obs: dict):
    if obs.get("kind") != "closed_loop":
        return None
    return obs["audio_s"] / (obs["t_end"] - obs["t0"])
