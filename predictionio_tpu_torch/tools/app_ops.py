"""Shared app lifecycle operations used by both the CLI and the admin REST
server (single copy of the create/delete cascades).

Port copy: ``predictionio_tpu/tools/app_ops.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import AccessKey, App


def create_app(name: str, description: str = "", access_key: str = "") -> tuple[App, str]:
    """Create app + default channel + access key. Raises ValueError if the
    name is taken."""
    apps = storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise ValueError(f"app {name!r} already exists")
    app = App(name=name, description=description)
    apps.insert(app)
    storage.get_l_events().init_channel(app.id)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(key=access_key, app_id=app.id)
    )
    return app, key


def delete_app_cascade(app: App) -> None:
    """Full teardown: channel events + channel meta + default-channel events
    + access keys + the app record."""
    le = storage.get_l_events()
    channels = storage.get_meta_data_channels()
    for ch in channels.get_by_app(app.id):
        le.remove_channel(app.id, ch.id)
        channels.delete(ch.id)
    le.remove_channel(app.id)
    keys = storage.get_meta_data_access_keys()
    for ak in keys.get_by_app_id(app.id):
        keys.delete(ak.key)
    storage.get_meta_data_apps().delete(app.id)


def delete_app_data(
    app: App, channel_name: str | None = None, all_channels: bool = False
) -> None:
    """Wipe event data. Default channel only unless ``channel_name`` (one
    named channel) or ``all_channels`` (default + every named channel).
    Raises LookupError for an unknown channel name."""
    le = storage.get_l_events()
    channels = storage.get_meta_data_channels()
    if channel_name:
        match = [c for c in channels.get_by_app(app.id) if c.name == channel_name]
        if not match:
            raise LookupError(f"channel {channel_name!r} does not exist")
        le.remove_channel(app.id, match[0].id)
        le.init_channel(app.id, match[0].id)
        return
    le.remove_channel(app.id)
    le.init_channel(app.id)
    if all_channels:
        for ch in channels.get_by_app(app.id):
            le.remove_channel(app.id, ch.id)
            le.init_channel(app.id, ch.id)
