"""``pio app ...`` and ``pio accesskey ...`` verbs.

Behavioral model: reference ``tools/.../console/{App,AccessKey}.scala``
(apache/predictionio layout, unverified -- SURVEY.md section 2.4 #27): app
new prints appId + access key; channel management validates names; accesskey
supports per-key event whitelists.

Port copy: ``predictionio_tpu/tools/app_commands.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

import argparse

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel


def register(sub: argparse._SubParsersAction) -> None:
    app = sub.add_parser("app", help="manage apps")
    app_sub = app.add_subparsers(dest="subcommand", required=True)

    new = app_sub.add_parser("new", help="create a new app")
    new.add_argument("name")
    new.add_argument("--description", default="")
    new.add_argument("--access-key", default="", help="use this access key instead of generating one")
    new.set_defaults(func=cmd_app_new)

    app_sub.add_parser("list", help="list apps").set_defaults(func=cmd_app_list)

    show = app_sub.add_parser("show", help="show app details")
    show.add_argument("name")
    show.set_defaults(func=cmd_app_show)

    delete = app_sub.add_parser("delete", help="delete an app and its data")
    delete.add_argument("name")
    delete.add_argument("--force", "-f", action="store_true")
    delete.set_defaults(func=cmd_app_delete)

    data_delete = app_sub.add_parser("data-delete", help="delete an app's event data")
    data_delete.add_argument("name")
    data_delete.add_argument("--channel", default=None)
    data_delete.add_argument("--all", action="store_true", help="delete all channels' data")
    data_delete.add_argument("--force", "-f", action="store_true")
    data_delete.set_defaults(func=cmd_app_data_delete)

    ch_new = app_sub.add_parser("channel-new", help="add a channel to an app")
    ch_new.add_argument("name")
    ch_new.add_argument("channel")
    ch_new.set_defaults(func=cmd_channel_new)

    ch_del = app_sub.add_parser("channel-delete", help="remove a channel and its data")
    ch_del.add_argument("name")
    ch_del.add_argument("channel")
    ch_del.add_argument("--force", "-f", action="store_true")
    ch_del.set_defaults(func=cmd_channel_delete)

    ak = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = ak.add_subparsers(dest="subcommand", required=True)

    ak_new = ak_sub.add_parser("new", help="create an access key for an app")
    ak_new.add_argument("app_name")
    ak_new.add_argument("events", nargs="*", help="optional event whitelist")
    ak_new.add_argument("--access-key", default="")
    ak_new.set_defaults(func=cmd_accesskey_new)

    ak_list = ak_sub.add_parser("list", help="list access keys")
    ak_list.add_argument("app_name", nargs="?")
    ak_list.set_defaults(func=cmd_accesskey_list)

    ak_del = ak_sub.add_parser("delete", help="delete an access key")
    ak_del.add_argument("key")
    ak_del.set_defaults(func=cmd_accesskey_delete)


def _require_app(name: str) -> App:
    app = storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise SystemExit(f"Error: app {name!r} does not exist.")
    return app


def cmd_app_new(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.app_ops import create_app

    try:
        app, key = create_app(args.name, args.description, args.access_key)
    except ValueError as exc:
        print(f"Error: {exc}.")
        return 1
    print("App created:")
    print(f"  Name: {args.name}")
    print(f"  ID: {app.id}")
    print(f"  Access Key: {key}")
    return 0


def cmd_app_list(args: argparse.Namespace) -> int:
    keys = storage.get_meta_data_access_keys()
    print(f"{'Name':<24} {'ID':<6} Access Key")
    for app in storage.get_meta_data_apps().get_all():
        app_keys = keys.get_by_app_id(app.id)
        first = app_keys[0].key if app_keys else ""
        print(f"{app.name:<24} {app.id:<6} {first}")
    return 0


def cmd_app_show(args: argparse.Namespace) -> int:
    app = _require_app(args.name)
    print(f"  Name: {app.name}")
    print(f"  ID: {app.id}")
    print(f"  Description: {app.description}")
    for ak in storage.get_meta_data_access_keys().get_by_app_id(app.id):
        allowed = ", ".join(ak.events) if ak.events else "(all)"
        print(f"  Access Key: {ak.key} | Events: {allowed}")
    for ch in storage.get_meta_data_channels().get_by_app(app.id):
        print(f"  Channel: {ch.name} (ID {ch.id})")
    return 0


def cmd_app_delete(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.app_ops import delete_app_cascade

    app = _require_app(args.name)
    if not args.force:
        confirm = input(f"Delete app {app.name!r} and ALL its data? (YES to confirm): ")
        if confirm != "YES":
            print("Aborted.")
            return 1
    delete_app_cascade(app)
    print(f"App {app.name!r} deleted.")
    return 0


def cmd_app_data_delete(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.app_ops import delete_app_data

    app = _require_app(args.name)
    if not args.force:
        confirm = input(f"Delete event data of app {app.name!r}? (YES to confirm): ")
        if confirm != "YES":
            print("Aborted.")
            return 1
    try:
        delete_app_data(app, channel_name=args.channel, all_channels=args.all)
    except LookupError as exc:
        print(f"Error: {exc}.")
        return 1
    print("Event data deleted.")
    return 0


def cmd_channel_new(args: argparse.Namespace) -> int:
    app = _require_app(args.name)
    if not Channel.is_valid_name(args.channel):
        print(f"Error: invalid channel name {args.channel!r}.")
        return 1
    channels = storage.get_meta_data_channels()
    if any(c.name == args.channel for c in channels.get_by_app(app.id)):
        print(f"Error: channel {args.channel!r} already exists.")
        return 1
    ch_id = channels.insert(Channel(name=args.channel, app_id=app.id))
    storage.get_l_events().init_channel(app.id, ch_id)
    print(f"Channel {args.channel!r} created (ID {ch_id}).")
    return 0


def cmd_channel_delete(args: argparse.Namespace) -> int:
    app = _require_app(args.name)
    channels = storage.get_meta_data_channels()
    match = [c for c in channels.get_by_app(app.id) if c.name == args.channel]
    if not match:
        print(f"Error: channel {args.channel!r} does not exist.")
        return 1
    if not args.force:
        confirm = input(f"Delete channel {args.channel!r} and its data? (YES to confirm): ")
        if confirm != "YES":
            print("Aborted.")
            return 1
    storage.get_l_events().remove_channel(app.id, match[0].id)
    channels.delete(match[0].id)
    print(f"Channel {args.channel!r} deleted.")
    return 0


def cmd_accesskey_new(args: argparse.Namespace) -> int:
    app = _require_app(args.app_name)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(key=args.access_key, app_id=app.id, events=list(args.events))
    )
    print(f"Access Key: {key}")
    return 0


def cmd_accesskey_list(args: argparse.Namespace) -> int:
    keys = storage.get_meta_data_access_keys()
    records = (
        keys.get_by_app_id(_require_app(args.app_name).id)
        if args.app_name
        else keys.get_all()
    )
    print(f"{'Access Key':<68} {'App ID':<7} Allowed Events")
    for ak in records:
        allowed = ", ".join(ak.events) if ak.events else "(all)"
        print(f"{ak.key:<68} {ak.app_id:<7} {allowed}")
    return 0


def cmd_accesskey_delete(args: argparse.Namespace) -> int:
    keys = storage.get_meta_data_access_keys()
    if keys.get(args.key) is None:
        print("Error: access key not found.")
        return 1
    keys.delete(args.key)
    print("Access key deleted.")
    return 0
