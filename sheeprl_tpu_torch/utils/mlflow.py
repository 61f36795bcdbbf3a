"""MLflow model registry (counterpart of ``sheeprl_tpu/utils/mlflow.py``).

:class:`MlflowModelManager` registers, transitions, downloads and deletes
model versions, keeping the JAX package's markdown changelog on the
registered model and on each version.  :func:`log_models` logs a run's
models as pickled artifacts and registers each under its
``model_manager.models`` name; a model is pickled as the JAX package pickles
its params (``pickle.dump(npify(params))``): the flax tree that
``interop/flax_params.py`` dumps the modules to, keys sorted at every level
as ``jax.tree_util`` leaves them, leaves numpy arrays, so an artifact the
port registered loads in either package.  Everything is gated on mlflow
being installed: the API exists and raises a clear error without it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import warnings
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.utils.imports import _IS_MLFLOW_AVAILABLE


_VERSION_MD_TEMPLATE = "## **Version {}**\n"


class MlflowModelManager:
    """Register / transition / download / delete model versions in the MLflow
    registry, keeping a markdown changelog on both the registered model and
    each version."""

    def __init__(self, runtime, tracking_uri: Optional[str] = None):
        if not _IS_MLFLOW_AVAILABLE:
            raise ModuleNotFoundError(
                "mlflow is not installed; install it to use the model registry "
                "(the training loops run without it)"
            )
        import mlflow
        from mlflow.tracking import MlflowClient

        self.runtime = runtime
        self.tracking_uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI")
        mlflow.set_tracking_uri(self.tracking_uri)
        self.client = MlflowClient()

    # -- the changelog's pieces ----------------------------------------------
    @staticmethod
    def _get_author_and_date() -> str:
        import getpass
        from datetime import datetime

        return (
            f"**Author**: {getpass.getuser()}\n\n"
            f"**Date**: {datetime.now().strftime('%d/%m/%Y %H:%M:%S')}\n\n"
        )

    @staticmethod
    def _generate_description(description: Optional[str] = None) -> str:
        return f"**Description**: {description}\n\n" if description else ""

    def _safe_get_stage(self, model_name: str, version: int) -> Optional[str]:
        try:
            return self.client.get_model_version(model_name, str(version)).current_stage
        except Exception:
            warnings.warn(f"Model {model_name} version {version} not found")
            return None

    def _print(self, *args: Any) -> None:
        printer = getattr(self.runtime, "print", print)
        printer(*args)

    # -- registry operations -------------------------------------------------
    def register_model(self, model_location: str, model_name: str, description=None, tags=None):
        import mlflow

        model_version = mlflow.register_model(model_uri=model_location, name=model_name, tags=tags)
        self._print(f"Registered model {model_name} with version {model_version.version}")
        registered_description = self.client.get_registered_model(model_name).description or ""
        header = "# MODEL CHANGELOG\n" if str(model_version.version) == "1" else ""
        entry = _VERSION_MD_TEMPLATE.format(model_version.version)
        entry += self._get_author_and_date()
        entry += self._generate_description(description)
        self.client.update_registered_model(model_name, header + registered_description + entry)
        self.client.update_model_version(model_name, model_version.version, "# MODEL CHANGELOG\n" + entry)
        return model_version

    def get_latest_version(self, model_name: str):
        versions = self.client.search_model_versions(f"name = '{model_name}'")
        return max(versions, key=lambda v: int(v.version)) if versions else None

    def transition_model(self, model_name: str, version: int, stage: str, description=None):
        previous_stage = self._safe_get_stage(model_name, version)
        if previous_stage is None:
            return None
        if previous_stage.lower() == str(stage).lower():
            warnings.warn(f"Model {model_name} version {version} is already in stage {stage}")
            return self.client.get_model_version(model_name, str(version))
        self._print(f"Transitioning model {model_name} version {version} from {previous_stage} to {stage}")
        model_version = self.client.transition_model_version_stage(model_name, str(version), stage)
        registered_description = self.client.get_registered_model(model_name).description or ""
        version_description = self.client.get_model_version(model_name, str(version)).description or ""
        entry = "## **Transition:**\n"
        entry += f"### Version {model_version.version} from {previous_stage} to {model_version.current_stage}\n"
        entry += self._get_author_and_date()
        entry += self._generate_description(description)
        self.client.update_registered_model(model_name, registered_description + entry)
        self.client.update_model_version(model_name, model_version.version, version_description + entry)
        return model_version

    def download_model(self, model_name: str, version: int, output_path: str):
        import mlflow

        os.makedirs(output_path, exist_ok=True)
        return mlflow.artifacts.download_artifacts(artifact_uri=f"models:/{model_name}/{version}",
                                                   dst_path=output_path)

    def delete_model(self, model_name: str, version: int, description=None):
        model_stage = self._safe_get_stage(model_name, version)
        if model_stage is None:
            return
        self._print(f"Deleting model {model_name} version {version}")
        self.client.delete_model_version(model_name, str(version))
        registered_description = self.client.get_registered_model(model_name).description or ""
        entry = "## **Deletion:**\n"
        entry += f"### Version {version} from stage: {model_stage}\n"
        entry += self._get_author_and_date()
        entry += self._generate_description(description)
        self.client.update_registered_model(model_name, registered_description + entry)

    def register_best_models(
        self,
        experiment_name: str,
        models_info: Dict[str, Dict[str, Any]],
        metric: str = "Test/cumulative_reward",
        mode: str = "max",
    ) -> Optional[Dict[str, Any]]:
        """Register, for every model in ``models_info`` (``{key: {path, name,
        description, tags}}``), the version logged by the experiment's best
        run according to ``metric``."""
        if mode not in ("max", "min"):
            raise ValueError(f"Mode must be either 'max' or 'min', got {mode}")
        experiment = self.client.get_experiment_by_name(experiment_name)
        if experiment is None:
            self._print(f"No experiment named {experiment_name}")
            return None
        runs = self.client.search_runs(experiment_ids=[experiment.experiment_id])
        if len(runs) == 0:
            self._print(f"No runs found for experiment {experiment_name}")
            return None

        models_path = [v["path"] for v in models_info.values()]
        best_run = None
        best_run_artifacts: Optional[set] = None
        sign = 1.0 if mode == "max" else -1.0
        for run in runs:
            run_artifacts = [x.path for x in self.client.list_artifacts(run.info.run_id) if x.path in models_path]
            if len(run_artifacts) == 0 or run.data.metrics.get(metric) is None:
                continue
            if best_run is None or sign * run.data.metrics[metric] > sign * best_run.data.metrics[metric]:
                best_run = run
                best_run_artifacts = set(run_artifacts)
        if best_run is None:
            self._print(f"No runs found for experiment {experiment_name} with the given metric")
            return None

        models_version = {}
        for k, v in models_info.items():
            if v["path"] in best_run_artifacts:
                models_version[k] = self.register_model(
                    model_location=f"runs:/{best_run.info.run_id}/{v['path']}",
                    model_name=v["name"],
                    description=v.get("description"),
                    tags=v.get("tags"),
                )
        return models_version


def flax_tree(tree: Any) -> Any:
    """``tree`` as ``jax.tree_util.tree_map(np.asarray, tree)`` leaves it:
    the keys of every dict sorted, lists and tuples kept, None kept, every
    other leaf a numpy array (a tensor copied to the host first)."""
    from sheeprl_tpu_torch.utils.checkpoint import npify

    if isinstance(tree, dict):
        return {k: flax_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(flax_tree(v) for v in tree)
    if tree is None:
        return None
    return np.asarray(npify(tree))


def log_models(cfg, models: Dict[str, Any], log_dir: str, run_id: Optional[str] = None) -> Dict[str, Any]:
    """Log each of ``models`` (name -> flax tree) that ``cfg.model_manager.models``
    names as an MLflow artifact, pickled as the JAX package pickles it, and
    register it under its ``model_name``; returns the registered versions.
    Without mlflow: a warning, and nothing is logged."""
    if not _IS_MLFLOW_AVAILABLE:
        warnings.warn("mlflow is not installed: skipping model registration")
        return {}
    import mlflow

    infos = {}
    with mlflow.start_run(run_id=run_id, nested=True) as run:
        for name, params in models.items():
            if name not in cfg.model_manager.models:
                continue
            meta = cfg.model_manager.models[name]
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, f"{name}.pkl")
                with open(path, "wb") as fp:
                    pickle.dump(flax_tree(params), fp)
                mlflow.log_artifact(path, artifact_path=name)
            model_uri = f"runs:/{run.info.run_id}/{name}"
            infos[name] = mlflow.register_model(model_uri, meta["model_name"], tags=meta.get("tags"))
    return infos


def register_model_from_checkpoint(cfg) -> None:
    """``python -m sheeprl_tpu_torch registration``'s body: the models of
    the checkpoint at ``cfg.checkpoint_path`` (either package's) that
    ``cfg.model_manager.models`` names, logged and registered."""
    if not _IS_MLFLOW_AVAILABLE:
        raise ModuleNotFoundError("mlflow is not installed; cannot register models")
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    state = load_state(cfg.checkpoint_path)
    models = {k: state[k] for k in cfg.model_manager.models.keys() if k in state}
    log_models(cfg, models, log_dir=os.path.dirname(cfg.checkpoint_path))
