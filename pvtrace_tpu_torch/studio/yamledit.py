"""Span-based comment-preserving YAML editing.

The reference studio round-trips the scene document with ruamel so user
comments survive GUI patches (the reference's
``pvtrace/studio/server.py:330-471``). ruamel is not available here; instead of
re-serialising the whole document (which drops comments), every patch
operation is expressed as a small set of **text splices** located with
``yaml.compose`` source marks: set/replace a value's character span,
insert a new mapping entry after the last entry of its section, or
delete an entry's line span. Text outside the spliced spans — comments,
blank lines, key ordering, quoting style — is untouched.

Primitives (all take and return document text):

* :func:`set_value` — replace the value at a mapping path, creating
  intermediate mappings/keys as needed;
* :func:`delete_key` — remove a mapping entry (its full line span);
* :func:`get_value` — read the parsed value at a path (convenience).

Values are rendered with the same flow-style conventions the studio
uses elsewhere (lists inline, nested specs as indented block maps).
"""
import io

import yaml


class _Flow(list):
    pass


def _flow_representer(dumper, data):
    return dumper.represent_sequence(
        "tag:yaml.org,2002:seq", data, flow_style=True
    )


yaml.SafeDumper.add_representer(_Flow, _flow_representer)


def _flowify(value):
    """Deep-convert lists to flow-rendered lists inside a dict tree."""
    if isinstance(value, dict):
        return {k: _flowify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return _Flow([_flowify(v) for v in value])
    return value


def _compose(text):
    node = yaml.compose(io.StringIO(text))
    if node is None:
        raise ValueError("Document is empty.")
    if not isinstance(node, yaml.MappingNode):
        raise ValueError("Document is not a YAML mapping.")
    return node


def _entries(mapping_node):
    """[(key_str, key_node, value_node)] of a MappingNode."""
    return [
        (str(key_node.value), key_node, value_node)
        for key_node, value_node in mapping_node.value
    ]


def _find_entry(mapping_node, key):
    for name, key_node, value_node in _entries(mapping_node):
        if name == str(key):
            return key_node, value_node
    return None, None


def _walk_mappings(root, path):
    """Follow `path` through nested MappingNodes as far as it exists.

    Returns (chain, remaining): `chain[i]` is the mapping holding
    `path[i]` (chain[0] is root), `remaining` the path suffix whose
    keys do not exist (or whose first key holds a non-mapping leaf).
    """
    chain = [root]
    current = root
    for i, key in enumerate(path):
        _key_node, value_node = _find_entry(current, key)
        if value_node is None or not isinstance(value_node, yaml.MappingNode):
            return chain, list(path[i:])
        chain.append(value_node)
        current = value_node
    return chain, []


def render_value(value, indent=0):
    """Render a patch value as YAML text.

    Scalars render inline; lists render flow-style (`[a, b, c]`,
    matching hand-written scene files); dicts render as an indented
    block mapping (caller places it on its own line(s)).
    """
    if isinstance(value, dict):
        block = yaml.safe_dump(
            _flowify(value), sort_keys=False, default_flow_style=False
        ).rstrip("\n")
        pad = " " * indent
        return "\n".join(pad + line for line in block.splitlines())
    if isinstance(value, (list, tuple)):
        return _render_flow(value)
    if value is None:
        return "null"
    rendered = yaml.safe_dump(value, default_flow_style=True).strip()
    if rendered.endswith("\n..."):  # scalar document-end marker
        rendered = rendered[: -len("\n...")].strip()
    return rendered


def _render_flow(value):
    return "[" + ", ".join(_render_flow_any(v) for v in value) + "]"


def _render_flow_any(value):
    """Flow-style (inline) rendering, dicts and lists recursively — for
    splices inside `{...}`/`[...]`, where block syntax would not
    parse."""
    if isinstance(value, dict):
        return "{" + ", ".join(
            f"{k}: {_render_flow_any(v)}" for k, v in value.items()
        ) + "}"
    if isinstance(value, (list, tuple)):
        return _render_flow(value)
    return render_value(value)


def _line_start(text, index):
    return text.rfind("\n", 0, index) + 1


def _line_end(text, index):
    """Index just past the newline of the line containing `index`."""
    end = text.find("\n", index)
    return len(text) if end < 0 else end + 1


def _trim_end(text, start, end):
    """End of actual content in [start, end): block collections'
    end_mark extends through trailing whitespace into the next token's
    line, which a splice must not swallow."""
    return start + len(text[start:end].rstrip(" \n"))


def _entry_span(text, key_node, value_node):
    """[start, end) character span of a whole mapping entry: from the
    key's line start through the end of the value's last content line
    (a comment on a *following* line is kept)."""
    start = _line_start(text, key_node.start_mark.index)
    content_end = _trim_end(
        text, key_node.start_mark.index, value_node.end_mark.index
    )
    end = _line_end(text, max(content_end - 1, 0))
    return start, end


def _indent_of(text, mark_index):
    start = _line_start(text, mark_index)
    line = text[start:_line_end(text, start)]
    return len(line) - len(line.lstrip(" "))


def set_value(text, path, value):
    """Replace (or create) the value at mapping `path`; comments and
    formatting outside the spliced span survive."""
    if not path:
        raise ValueError("set_value needs a non-empty path.")
    root = _compose(text)
    chain, remaining = _walk_mappings(root, path[:-1])
    if remaining:
        # Intermediate mappings missing: insert the whole nested spec
        # into the deepest existing mapping.
        spec = value
        for key in reversed(list(path[len(chain) - 1:])[1:]):
            spec = {key: spec}
        key_node, _leaf = _find_entry(chain[-1], remaining[0])
        if key_node is not None:
            # The key exists but holds a non-mapping leaf: replace it
            # wholesale with the nested spec (dict branch below).
            prefix = list(path[: len(chain) - 1]) + [remaining[0]]
            return set_value(text, prefix, spec)
        return _insert_entry(text, chain, remaining[0], spec)
    holder = chain[-1]
    key_node, value_node = _find_entry(holder, path[-1])
    if key_node is None:
        return _insert_entry(text, chain, path[-1], value)
    if isinstance(value, dict):
        if getattr(holder, "flow_style", False):
            # Inside `{...}`: block syntax would not parse — splice the
            # dict inline.
            start = value_node.start_mark.index
            end = _trim_end(text, start, value_node.end_mark.index)
            return text[:start] + _render_flow_any(value) + text[end:]
        # Replace the whole entry with a block-styled one.
        indent = _indent_of(text, key_node.start_mark.index)
        start, end = _entry_span(text, key_node, value_node)
        pad = " " * indent
        rendered = render_value(value, indent + 2)
        entry_text = f"{pad}{path[-1]}:\n{rendered}\n"
        return text[:start] + entry_text + text[end:]
    rendered = render_value(value)
    start = value_node.start_mark.index
    end = _trim_end(text, start, value_node.end_mark.index)
    return text[:start] + rendered + text[end:]


def _insert_entry(text, chain, key, value):
    """Insert `key: value` as a new entry of the mapping `chain[-1]`
    (ancestor chain included for flow/empty-mapping handling)."""
    holder = chain[-1]
    entries = _entries(holder)
    root = chain[0]
    if entries and getattr(holder, "flow_style", False):
        # Non-empty `{a: 1, ...}`: insert inline before the closing
        # brace, keeping every sibling entry.
        end = holder.end_mark.index
        brace = text.rfind("}", holder.start_mark.index, end)
        rendered = _render_flow_any({key: value})[1:-1]  # strip { }
        prefix = text[:brace].rstrip()
        if prefix.endswith(","):  # YAML allows a trailing comma
            prefix = prefix[:-1].rstrip()
        return prefix + ", " + rendered + text[brace:]
    if not entries:
        # Empty (`{}`) mapping: no block entries to append after, so
        # rewrite just this mapping's own span as a block mapping (an
        # empty flow mapping cannot contain comments).
        if holder is root:
            rendered = render_value({key: value}, 0)
            body = text.rstrip()
            sep = "\n" if body else ""
            return body + sep + rendered + "\n"
        parent = chain[-2]
        parent_key_node = None
        for _name, pkey, pvalue in _entries(parent):
            if pvalue is holder:
                parent_key_node = pkey
                break
        indent = _indent_of(text, parent_key_node.start_mark.index) + 2
        rendered = render_value({key: value}, indent)
        start = holder.start_mark.index
        end = holder.end_mark.index
        # The `{}` sits inline after "section:"; the block replacement
        # starts on the next line.
        prefix = text[:start].rstrip(" ")
        suffix = text[end:]
        if not suffix.startswith("\n"):
            rendered += "\n" if suffix else ""
        return prefix + "\n" + rendered + suffix
    base_indent = _indent_of(text, entries[0][1].start_mark.index)
    pad = " " * base_indent
    if isinstance(value, dict):
        rendered = render_value(value, base_indent + 2)
        entry_text = f"{pad}{key}:\n{rendered}\n"
    else:
        entry_text = f"{pad}{key}: {render_value(value)}\n"
    _name, last_key, last_value = entries[-1]
    _start, end = _entry_span(text, last_key, last_value)
    if end > 0 and text[end - 1] != "\n":
        entry_text = "\n" + entry_text
    return text[:end] + entry_text + text[end:]


def delete_key(text, path):
    """Delete the mapping entry at `path` (its full line span)."""
    if not path:
        raise ValueError("delete_key needs a non-empty path.")
    root = _compose(text)
    chain, remaining = _walk_mappings(root, path[:-1])
    if remaining:
        raise KeyError(f"No such path: {path!r}")
    holder = chain[-1]
    key_node, value_node = _find_entry(holder, path[-1])
    if key_node is None:
        raise KeyError(f"No such key: {path!r}")
    if getattr(holder, "flow_style", False):
        # Inside `{...}`: splice out `key: value` plus one adjacent
        # comma; the only entry leaves `{}` (still inline).
        if len(_entries(holder)) == 1:
            start = holder.start_mark.index
            end = holder.end_mark.index
            return text[:start] + "{}" + text[end:]
        start = key_node.start_mark.index
        end = _trim_end(text, start, value_node.end_mark.index)
        after = end
        while after < len(text) and text[after] in " \t":
            after += 1
        if after < len(text) and text[after] == ",":
            after += 1
            while after < len(text) and text[after] in " \t":
                after += 1
            return text[:start] + text[after:]
        before = start
        while before > 0 and text[before - 1] in " \t":
            before -= 1
        if before > 0 and text[before - 1] == ",":
            before -= 1
        return text[:before] + text[end:]
    start, end = _entry_span(text, key_node, value_node)
    if len(_entries(holder)) == 1 and holder is not root:
        # Deleting the only entry would leave an invalid empty block
        # mapping; put `{}` in its place.
        pad = " " * _indent_of(text, key_node.start_mark.index)
        return text[:start] + pad + "{}\n" + text[end:]
    return text[:start] + text[end:]


def get_value(text, path):
    """Parsed value at `path` (safe_load semantics)."""
    data = yaml.safe_load(io.StringIO(text))
    for key in path:
        data = data[key]
    return data
