"""fill_useful_rows.engine: rows admitted by the engine's fills over the
engine's slots times the fills, in %. It counts slots, not rows encoded:
it reads as the fills' padding share only while every fill encodes all
the slots."""


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    admitted = [n for _, _, n in obs["steps"] if n > 0]
    if not admitted:
        return None
    return 100.0 * sum(admitted) / (len(admitted) * obs["slots"])
