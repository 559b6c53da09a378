"""Port-vs-JAX dress rehearsals as suite gates: ``scripts/dress_rehearsal_torch.py``
at 3 epochs on 60 train and 20 val mini-Flickr images, with the precomputed
teacher features and with a live tiny DINOv2 teacher. Every row within the
tolerances of ``scripts/dress_rehearsal.py``: epoch 0 (same weights, same
eval pipeline) at the exact-level bound, the final epoch and the CLIP-blind
percentages at the statistical ones. Both CLIs run on the CPU in
subprocesses (about 1-2 minutes a rehearsal)."""


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


def test_port_live_teacher_dress_rehearsal_against_the_jax_cli(tmp_path):
    """The live-teacher rehearsal: both CLIs load one seeded tiny DINOv2
    directory and run it in the step and the CLIP-blind check (no head, a
    deterministic crop). The same rows and tolerances, and both runs'
    first-step ``soft_loss`` equal to fp32 rounding (1e-4 relative)."""
    import re

    from scripts.dress_rehearsal_torch import run_all

    report = tmp_path / "report.md"
    rows, failures = run_all(str(tmp_path / "work"), epochs=3, n_train=60, n_val=20, seed=0,
                             out=str(report), live=True)
    assert len([r for r in rows if r[0] == "epoch0"]) == 9
    assert len([r for r in rows if r[0] == "final"]) == 7
    assert len([r for r in rows if r[0] == "clip_blind/val"]) == 3
    rel = re.search(r"first logged step: JAX step 1 soft_loss \S+, port step 1 soft_loss \S+, "
                    r"relative difference (\S+)", report.read_text())
    assert rel and float(rel.group(1)) <= 1e-4, report.read_text()
    assert not failures, "\n".join(failures)
