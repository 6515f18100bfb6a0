// Minimal dependency-free JSON value/parser/writer for the v2 protocol.
// Role parity: the reference Java client uses Jackson; this build is
// self-contained.
package torch.client;

import java.util.ArrayList;
import java.util.LinkedHashMap;
import java.util.List;
import java.util.Map;

public final class Json {
  public enum Type { NULL, BOOL, NUMBER, STRING, ARRAY, OBJECT }

  private final Type type;
  private final boolean boolValue;
  private final double numberValue;
  // integral numbers keep full 64-bit precision (double only has 53 bits)
  private final long longValue;
  private final boolean integral;
  private final String stringValue;
  private final List<Json> arrayValue;
  private final Map<String, Json> objectValue;

  private Json(Type type, boolean b, double n, long l, boolean integral,
               String s, List<Json> a, Map<String, Json> o) {
    this.type = type;
    this.boolValue = b;
    this.numberValue = n;
    this.longValue = l;
    this.integral = integral;
    this.stringValue = s;
    this.arrayValue = a;
    this.objectValue = o;
  }

  public static final Json NULL =
      new Json(Type.NULL, false, 0, 0, false, null, null, null);

  public static Json of(boolean b) {
    return new Json(Type.BOOL, b, 0, 0, false, null, null, null);
  }

  public static Json of(double n) {
    return new Json(Type.NUMBER, false, n, (long) n, false, null, null,
                    null);
  }

  public static Json of(long n) {
    return new Json(Type.NUMBER, false, n, n, true, null, null, null);
  }

  public static Json of(String s) {
    return new Json(Type.STRING, false, 0, 0, false, s, null, null);
  }

  public static Json array() {
    return new Json(Type.ARRAY, false, 0, 0, false, null,
                    new ArrayList<>(), null);
  }

  public static Json object() {
    return new Json(Type.OBJECT, false, 0, 0, false, null, null,
                    new LinkedHashMap<>());
  }

  public Json add(Json v) {
    arrayValue.add(v);
    return this;
  }

  public Json put(String key, Json v) {
    objectValue.put(key, v);
    return this;
  }

  public Type type() { return type; }
  public boolean asBool() { return boolValue; }
  public double asNumber() { return numberValue; }
  public long asLong() {
    return integral ? longValue : (long) numberValue;
  }
  public String asString() { return stringValue; }
  public List<Json> asArray() { return arrayValue; }
  public Map<String, Json> asObject() { return objectValue; }

  public boolean has(String key) {
    return type == Type.OBJECT && objectValue.containsKey(key);
  }

  public Json at(String key) {
    Json v = type == Type.OBJECT ? objectValue.get(key) : null;
    return v == null ? NULL : v;
  }

  // ---- writer ----

  public String dump() {
    StringBuilder sb = new StringBuilder();
    write(sb);
    return sb.toString();
  }

  private void write(StringBuilder sb) {
    switch (type) {
      case NULL: sb.append("null"); break;
      case BOOL: sb.append(boolValue); break;
      case NUMBER:
        if (integral) {
          sb.append(longValue);
        } else if (numberValue == Math.rint(numberValue)
                   && !Double.isInfinite(numberValue)) {
          sb.append((long) numberValue);
        } else {
          sb.append(numberValue);
        }
        break;
      case STRING: writeString(sb, stringValue); break;
      case ARRAY: {
        sb.append('[');
        for (int i = 0; i < arrayValue.size(); i++) {
          if (i > 0) sb.append(',');
          arrayValue.get(i).write(sb);
        }
        sb.append(']');
        break;
      }
      case OBJECT: {
        sb.append('{');
        boolean first = true;
        for (Map.Entry<String, Json> e : objectValue.entrySet()) {
          if (!first) sb.append(',');
          first = false;
          writeString(sb, e.getKey());
          sb.append(':');
          e.getValue().write(sb);
        }
        sb.append('}');
        break;
      }
      default: break;
    }
  }

  private static void writeString(StringBuilder sb, String s) {
    sb.append('"');
    for (int i = 0; i < s.length(); i++) {
      char c = s.charAt(i);
      switch (c) {
        case '"': sb.append("\\\""); break;
        case '\\': sb.append("\\\\"); break;
        case '\n': sb.append("\\n"); break;
        case '\r': sb.append("\\r"); break;
        case '\t': sb.append("\\t"); break;
        default:
          if (c < 0x20) {
            sb.append(String.format("\\u%04x", (int) c));
          } else {
            sb.append(c);
          }
      }
    }
    sb.append('"');
  }

  // ---- parser ----

  public static Json parse(String text) {
    Parser p = new Parser(text);
    Json v = p.parseValue();
    p.skipWs();
    if (!p.atEnd()) throw new IllegalArgumentException("trailing JSON");
    return v;
  }

  private static final class Parser {
    private final String s;
    private int pos = 0;

    Parser(String s) { this.s = s; }

    boolean atEnd() { return pos >= s.length(); }

    void skipWs() {
      while (pos < s.length() && Character.isWhitespace(s.charAt(pos)))
        pos++;
    }

    char peek() {
      skipWs();
      if (atEnd()) throw new IllegalArgumentException("unexpected end");
      return s.charAt(pos);
    }

    void expect(char c) {
      if (peek() != c)
        throw new IllegalArgumentException("expected '" + c + "' at "
                                           + pos);
      pos++;
    }

    Json parseValue() {
      char c = peek();
      switch (c) {
        case '{': return parseObject();
        case '[': return parseArray();
        case '"': return Json.of(parseString());
        case 't': literal("true"); return Json.of(true);
        case 'f': literal("false"); return Json.of(false);
        case 'n': literal("null"); return Json.NULL;
        default: return parseNumber();
      }
    }

    void literal(String lit) {
      skipWs();
      if (!s.startsWith(lit, pos))
        throw new IllegalArgumentException("bad literal at " + pos);
      pos += lit.length();
    }

    Json parseObject() {
      expect('{');
      Json obj = Json.object();
      if (peek() == '}') { pos++; return obj; }
      while (true) {
        String key = parseString();
        expect(':');
        obj.put(key, parseValue());
        char c = peek();
        pos++;
        if (c == '}') break;
        if (c != ',')
          throw new IllegalArgumentException("expected ',' or '}'");
      }
      return obj;
    }

    Json parseArray() {
      expect('[');
      Json arr = Json.array();
      if (peek() == ']') { pos++; return arr; }
      while (true) {
        arr.add(parseValue());
        char c = peek();
        pos++;
        if (c == ']') break;
        if (c != ',')
          throw new IllegalArgumentException("expected ',' or ']'");
      }
      return arr;
    }

    String parseString() {
      expect('"');
      StringBuilder sb = new StringBuilder();
      while (pos < s.length()) {
        char c = s.charAt(pos++);
        if (c == '"') return sb.toString();
        if (c == '\\') {
          char e = s.charAt(pos++);
          switch (e) {
            case '"': sb.append('"'); break;
            case '\\': sb.append('\\'); break;
            case '/': sb.append('/'); break;
            case 'b': sb.append('\b'); break;
            case 'f': sb.append('\f'); break;
            case 'n': sb.append('\n'); break;
            case 'r': sb.append('\r'); break;
            case 't': sb.append('\t'); break;
            case 'u':
              sb.append((char) Integer.parseInt(
                  s.substring(pos, pos + 4), 16));
              pos += 4;
              break;
            default:
              throw new IllegalArgumentException("bad escape");
          }
        } else {
          sb.append(c);
        }
      }
      throw new IllegalArgumentException("unterminated string");
    }

    Json parseNumber() {
      skipWs();
      int start = pos;
      boolean isDouble = false;
      if (pos < s.length() && s.charAt(pos) == '-') pos++;
      while (pos < s.length()) {
        char c = s.charAt(pos);
        if (c == '.' || c == 'e' || c == 'E') isDouble = true;
        if ((c >= '0' && c <= '9') || c == '.' || c == 'e' || c == 'E'
            || c == '+' || c == '-') {
          pos++;
        } else {
          break;
        }
      }
      String num = s.substring(start, pos);
      if (!isDouble) {
        try {
          return Json.of(Long.parseLong(num));
        } catch (NumberFormatException ignored) {
          // falls through to double for out-of-range integers
        }
      }
      return Json.of(Double.parseDouble(num));
    }
  }
}
