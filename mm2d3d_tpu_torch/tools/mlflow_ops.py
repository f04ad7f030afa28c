"""Experiment-ops CLIs against an MLflow tracking server (port of
`mm2d3d_tpu/tools/mlflow_ops.py`): upload an artifact, download a run's
artifacts, an HTML diff of one artifact file between two runs, and a copy
of a run (params, tags, metric histories, artifacts) to another server.

    python -m mm2d3d_tpu_torch.tools.mlflow_ops upload   --run-id R --path file
    python -m mm2d3d_tpu_torch.tools.mlflow_ops download --run-id R --out dir
    python -m mm2d3d_tpu_torch.tools.mlflow_ops diff     --run-a A --run-b B --file f
    python -m mm2d3d_tpu_torch.tools.mlflow_ops copy-run --run-id R \
        --src-uri http://a --dst-uri http://b

Needs the `mlflow` package, imported by each subcommand.
"""

from __future__ import annotations

import argparse
import contextlib
import difflib
import os


@contextlib.contextmanager
def tracking_uri(uri):
    """The `mlflow` module with its tracking server switched to `uri` (if
    given) for the block, restored after."""
    import mlflow

    prev = mlflow.get_tracking_uri()
    try:
        if uri:
            mlflow.set_tracking_uri(uri)
        yield mlflow
    finally:
        mlflow.set_tracking_uri(prev)


def upload(args):
    with tracking_uri(args.uri) as mlflow:
        client = mlflow.tracking.MlflowClient()
        client.log_artifact(args.run_id, args.path, artifact_path=args.dest)
        print(f"uploaded {args.path} to run {args.run_id}")


def download(args):
    with tracking_uri(args.uri) as mlflow:
        client = mlflow.tracking.MlflowClient()
        os.makedirs(args.out, exist_ok=True)
        path = client.download_artifacts(args.run_id, args.path or "", args.out)
        print(f"downloaded to {path}")


def diff(args):
    with tracking_uri(args.uri) as mlflow:
        client = mlflow.tracking.MlflowClient()
        pa = client.download_artifacts(args.run_a, args.file)
        pb = client.download_artifacts(args.run_b, args.file)
    with open(pa) as f:
        la = f.readlines()
    with open(pb) as f:
        lb = f.readlines()
    html = difflib.HtmlDiff().make_file(la, lb, args.run_a, args.run_b)
    out = args.out or "diff.html"
    with open(out, "w") as f:
        f.write(html)
    print(f"wrote {out}")


def copy_run(args):
    """Copy a run (params, tags, full metric histories, artifacts) across
    tracking servers."""
    from mlflow.tracking import MlflowClient

    src = MlflowClient(tracking_uri=args.src_uri)
    dst = MlflowClient(tracking_uri=args.dst_uri)

    run = src.get_run(args.run_id)
    exp_name = args.experiment or src.get_experiment(run.info.experiment_id).name
    exp = dst.get_experiment_by_name(exp_name)
    exp_id = exp.experiment_id if exp else dst.create_experiment(exp_name)

    new_run = dst.create_run(exp_id, tags=run.data.tags)
    for key, val in run.data.params.items():
        dst.log_param(new_run.info.run_id, key, val)
    for key in run.data.metrics:
        for m in src.get_metric_history(args.run_id, key):
            dst.log_metric(new_run.info.run_id, key, m.value,
                           timestamp=m.timestamp, step=m.step)
    tmp = src.download_artifacts(args.run_id, "")
    dst.log_artifacts(new_run.info.run_id, tmp)
    dst.set_terminated(new_run.info.run_id)
    print(f"copied run {args.run_id} -> {new_run.info.run_id}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("upload")
    p.add_argument("--run-id", required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--dest", default=None)
    p.add_argument("--uri", default=None)
    p.set_defaults(fn=upload)

    p = sub.add_parser("download")
    p.add_argument("--run-id", required=True)
    p.add_argument("--path", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--uri", default=None)
    p.set_defaults(fn=download)

    p = sub.add_parser("diff")
    p.add_argument("--run-a", required=True)
    p.add_argument("--run-b", required=True)
    p.add_argument("--file", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--uri", default=None)
    p.set_defaults(fn=diff)

    p = sub.add_parser("copy-run")
    p.add_argument("--run-id", required=True)
    p.add_argument("--src-uri", required=True)
    p.add_argument("--dst-uri", required=True)
    p.add_argument("--experiment", default=None)
    p.set_defaults(fn=copy_run)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
