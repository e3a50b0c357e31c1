"""obj_slot_idle_share.avenue: the share of the pair step's object solve
slots that carried no mover over the window: 100 (1 - sum of the
program's counter ``record/slots_active`` / (the slots of one pair step x
the pairs counted)).  None where the program counts nothing."""


def read(rec):
    active = (rec.get("counts") or {}).get("record/slots_active")
    if active is None or not rec.get("counted_pairs"):
        return None
    return 100.0 * (1.0 - active / (rec["slots_per_pair"] * rec["counted_pairs"]))
