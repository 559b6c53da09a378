"""Port-vs-JAX dress rehearsal as a suite gate: ``scripts/dress_rehearsal_torch.py``
at 3 epochs on 60 train and 20 val mini-Flickr images. Every row within the
tolerances of ``scripts/dress_rehearsal.py``: epoch 0 (same weights, same
eval pipeline) at the exact-level bound, the final epoch and the CLIP-blind
percentages at the statistical ones. Both CLIs run on the CPU in
subprocesses (about 1-2 minutes)."""


def test_port_dress_rehearsal_against_the_jax_cli(tmp_path):
    from scripts.dress_rehearsal_torch import run_all

    rows, failures = run_all(str(tmp_path / "work"), epochs=3, n_train=60, n_val=20, seed=0,
                             out=str(tmp_path / "report.md"))
    # the comparison is vacuous without its epoch-0 and CLIP-blind rows
    assert len([r for r in rows if r[0] == "epoch0"]) == 9
    assert len([r for r in rows if r[0] == "final"]) == 7
    assert len([r for r in rows if r[0] == "clip_blind/val"]) == 3
    assert (tmp_path / "work" / "torch_logs" / "run" / "clip_blind" /
            "clip_blind_train.json").exists()
    assert not failures, "\n".join(failures)
