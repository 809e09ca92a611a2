"""``mlflow.artifacts`` of the stand-in: ``download_artifacts`` copies a
run's artifacts (``runs:/<run id>/<path>``) out of the recording server."""
import os
import shutil

import mlflow


def download_artifacts(artifact_uri=None, dst_path=None, **kwargs):
    src = mlflow._resolve(artifact_uri)
    dst = os.path.join(dst_path, os.path.basename(src.rstrip("/")))
    mlflow._record("download_artifacts", artifact_uri=artifact_uri, files=mlflow._files(src))
    shutil.copytree(src, dst, dirs_exist_ok=True)
    return dst
